from vitax_torch.data.pipeline import (  # noqa: F401
    Batch,
    DataLoader,
    CIFAR10DataLoader,
    CIFAR100DataLoader,
    ImageNetDataLoader,
    TinyImageNetDataLoader,
    SyntheticDataLoader,
    DATALOADER_REGISTRY,
    get_dataloader,
    normalize,
)
