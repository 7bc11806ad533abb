"""Data for the port: the synthetic paper datasets (dense or ELL), the
LibSVM loaders (dense, streaming CSR and chunked) and the synthetic token
stream of the transformer trainer."""
from repro_torch.data.svm_datasets import PAPER_DATASETS, SVMDataset, make_dataset, partition  # noqa: F401
from repro_torch.data.libsvm import iter_libsvm_chunks, load_libsvm, load_libsvm_csr  # noqa: F401
from repro_torch.data.tokens import Batcher, TokenStreamConfig, synthetic_tokens  # noqa: F401
