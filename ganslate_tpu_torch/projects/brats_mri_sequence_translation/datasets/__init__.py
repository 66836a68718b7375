from .train_dataset import BratsDataset, BratsDatasetConfig
from .val_test_dataset import BratsValTestDataset, BratsValTestDatasetConfig
