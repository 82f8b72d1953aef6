"""Weight interop for the port."""
