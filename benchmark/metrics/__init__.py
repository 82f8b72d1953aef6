"""One reader per metric: ``read(record) -> value or None``, found by the
metric's name (``<name>.py``, else the part of the name before its first
dot). A reader that finds nothing to read returns None."""
