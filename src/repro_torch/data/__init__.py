"""Data for the port: the synthetic paper datasets (dense or ELL) and the
LibSVM loaders (dense, streaming CSR and chunked)."""
from repro_torch.data.svm_datasets import PAPER_DATASETS, SVMDataset, make_dataset, partition  # noqa: F401
from repro_torch.data.libsvm import iter_libsvm_chunks, load_libsvm, load_libsvm_csr  # noqa: F401
