"""Evaluation of the port: the scoring pass and its CSV tables."""

from pangu_tpu_torch.eval.evaluate import evaluate, make_score_step  # noqa: F401
