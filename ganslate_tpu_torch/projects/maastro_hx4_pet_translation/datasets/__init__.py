from .train_dataset import (HX4PETTranslationTrainDataset,
                            HX4PETTranslationTrainDatasetConfig)
from .val_test_dataset import (HX4PETTranslationValTestDataset,
                               HX4PETTranslationValTestDatasetConfig)
