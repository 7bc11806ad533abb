"""Hinge-subgradient kernels for Hopper: ``fleet_half_step``, ``margins``
and ``grad_update`` (dense training) in ``hinge_subgrad.py``, the padded-ELL
training kernels in ``sparse.py``, ``dense_scores`` and
``ell_scores_prefetch`` (serving) in ``predict.py``, their CUDA sources
under ``csrc/``, plain PyTorch oracles in ``ref.py`` and the dispatch layer
in ``ops.py``."""
