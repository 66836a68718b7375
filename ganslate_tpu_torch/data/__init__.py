from ganslate_tpu_torch.data.paired_image_dataset import (PairedImageDataset,
                                                          PairedImageDatasetConfig)
from ganslate_tpu_torch.data.unpaired_image_dataset import (UnpairedImageDataset,
                                                            UnpairedImageDatasetConfig)
