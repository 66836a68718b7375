"""HX4-PET validation and test dataset (the twin of the JAX project's
`datasets/val_test_dataset.py`): whole volumes (padded to (64, 512, 512)
without patch-based inference), the BODY and GTV masks and the NRRD
geometry in the sample, `denormalize` to TBR for the metrics, and `save`
of a predicted volume as NRRD in SUV. Channels-last arrays."""

import logging
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.data.utils.normalization import min_max_denormalize
from ganslate_tpu_torch.data.utils.ops import pad
from ganslate_tpu_torch.utils import sitk_utils

from .train_dataset import read_suv_aorta_mean_values
from .utils.basic import apply_body_mask, clip_and_min_max_normalize, sitk2np

logger = logging.getLogger(__name__)


@dataclass
class HX4PETTranslationValTestDatasetConfig(configs.base.BaseDatasetConfig):
    """Note: the val dataset is paired and does not supply ldCT."""
    hu_range: Tuple[int, int] = (-1000, 2000)
    fdg_suv_range: Tuple[float, float] = (0.0, 15.0)
    hx4_tbr_range: Tuple[float, float] = (0.0, 3.0)
    # With sliding-window inference the engine handles patching; without it,
    # volumes are padded to a fixed shape for the U-Net's down/upsampling.
    use_patch_based_inference: bool = False
    # Supplying masks adds masked metrics (slower validation).
    supply_masks: bool = False
    # HX4CycleGANBalanced needs a dummy 2nd channel on B.
    model_is_hx4_cyclegan_balanced: bool = False


class HX4PETTranslationValTestDataset:

    def __init__(self, conf):
        dataset_conf = conf[conf.mode].dataset
        root_path = dataset_conf.root
        self.patient_ids = sorted(os.listdir(root_path))

        self.image_paths = {'FDG-PET': [], 'pCT': [], 'HX4-PET': [],
                            'body-mask': [], 'gtv-mask': []}
        for p_id in self.patient_ids:
            self.image_paths['FDG-PET'].append(f"{root_path}/{p_id}/fdg_pet.nrrd")
            self.image_paths['pCT'].append(f"{root_path}/{p_id}/pct.nrrd")
            self.image_paths['HX4-PET'].append(f"{root_path}/{p_id}/hx4_pet_reg.nrrd")
            self.image_paths['body-mask'].append(f"{root_path}/{p_id}/pct_body.nrrd")
            self.image_paths['gtv-mask'].append(f"{root_path}/{p_id}/pct_gtv.nrrd")

        self.num_datapoints = len(self.image_paths['FDG-PET'])
        self.suv_aorta_mean_values = read_suv_aorta_mean_values(root_path)

        self.hu_min, self.hu_max = dataset_conf.hu_range
        self.fdg_suv_min, self.fdg_suv_max = dataset_conf.fdg_suv_range
        self.hx4_tbr_min, self.hx4_tbr_max = dataset_conf.hx4_tbr_range

        self.use_patch_based_inference = dataset_conf.use_patch_based_inference
        self.supply_masks = dataset_conf.supply_masks
        self.model_is_hx4_cyclegan_balanced = dataset_conf.model_is_hx4_cyclegan_balanced

    def __len__(self):
        return self.num_datapoints

    def __getitem__(self, index):
        index = index % self.num_datapoints

        images = {}
        for k in ('FDG-PET', 'pCT', 'HX4-PET', 'body-mask', 'gtv-mask'):
            try:
                images[k] = sitk_utils.load(self.image_paths[k][index])
            except (RuntimeError, FileNotFoundError):
                if k == 'body-mask':
                    logger.warning(
                        f"Patient {self.patient_ids[index]} does not have a body "
                        f"mask. It will be generated automatically.")
                    images[k] = None
                else:
                    raise

        metadata = {
            'patient_id': self.patient_ids[index],
            'size': images['FDG-PET'].GetSize(),
            'origin': images['FDG-PET'].GetOrigin(),
            'spacing': images['FDG-PET'].GetSpacing(),
            'direction': images['FDG-PET'].GetDirection(),
            'dtype': sitk_utils.get_npy_dtype(images['FDG-PET']),
        }

        images = sitk2np(images)
        images = apply_body_mask(images,
                                 generate_body_mask=images['body-mask'] is None)

        if not self.use_patch_based_inference:
            for k in images:
                images[k] = pad(images[k], target_shape=(64, 512, 512))

        patient_id = self.patient_ids[index]
        images['HX4-PET'] = images['HX4-PET'] / self.suv_aorta_mean_values[patient_id]

        images['FDG-PET'] = clip_and_min_max_normalize(
            images['FDG-PET'], self.fdg_suv_min, self.fdg_suv_max)
        images['pCT'] = clip_and_min_max_normalize(
            images['pCT'], self.hu_min, self.hu_max)
        images['HX4-PET'] = clip_and_min_max_normalize(
            images['HX4-PET'], self.hx4_tbr_min, self.hx4_tbr_max)

        A = np.stack((images['FDG-PET'], images['pCT']), axis=-1).astype(np.float32)
        if self.model_is_hx4_cyclegan_balanced:
            zeros_dummy = np.zeros_like(images['HX4-PET'])
            B = np.stack((images['HX4-PET'], zeros_dummy), axis=-1).astype(np.float32)
        else:
            B = images['HX4-PET'][..., None].astype(np.float32)

        sample_dict = {'A': A, 'B': B}
        if self.supply_masks:
            sample_dict['masks'] = {
                'BODY': images['body-mask'][..., None].astype(np.float32),
                'GTV': images['gtv-mask'][..., None].astype(np.float32),
            }
        sample_dict['metadata'] = metadata
        return sample_dict

    def denormalize(self, tensor):
        """Metrics in the original TBR range."""
        return min_max_denormalize(np.asarray(tensor), self.hx4_tbr_min,
                                   self.hx4_tbr_max)

    def save(self, tensor, save_dir, metadata):
        """Save a predicted volume as NRRD (TBR -> SUV, original geometry)."""
        tensor = np.asarray(tensor)
        if self.model_is_hx4_cyclegan_balanced:
            tensor = tensor[..., 0]  # channel-last: HX4-PET is channel 0
        else:
            tensor = tensor.squeeze()

        tensor = min_max_denormalize(tensor, self.hx4_tbr_min, self.hx4_tbr_max)
        patient_id = metadata['patient_id']
        tensor = tensor * self.suv_aorta_mean_values[patient_id]

        image = sitk_utils.tensor_to_sitk_image(
            tensor, metadata['origin'], metadata['spacing'],
            metadata['direction'], metadata['dtype'])
        os.makedirs(save_dir, exist_ok=True)
        sitk_utils.write(image, f"{save_dir}/{patient_id}.nrrd")
