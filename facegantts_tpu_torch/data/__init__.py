from facegantts_tpu_torch.data.dataset import (  # noqa: F401
    BucketedLoader,
    PackedDataset,
    SyntheticDataset,
    collate,
    load_packed,
)
