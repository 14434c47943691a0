"""The benchmark of ``cova_tpu_torch``: one cell a run (``run.py``)."""
