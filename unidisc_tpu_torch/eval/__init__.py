"""Evaluation: the metric battery, its judges, scoring and auto-enhance
(port of ``unidisc_tpu/eval``)."""
