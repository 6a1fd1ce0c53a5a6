"""The benchmark of modl_tpu_torch (``python3 perfbench/run.py``)."""
