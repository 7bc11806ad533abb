"""Flash attention for Hopper: the ``flash_attention`` kernel and its plain
version in ``flash_attention.py``, its CUDA source under ``csrc/``, the GQA
entry point and cost model in ``ops.py`` and the oracle in ``ref.py``."""
