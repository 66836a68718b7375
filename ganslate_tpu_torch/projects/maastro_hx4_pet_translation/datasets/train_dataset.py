"""HX4-PET translation training dataset (the twin of the JAX project's
`datasets/train_dataset.py`): A = [FDG-PET, pCT], B = [HX4-PET(, ldCT)];
body-mask filtering, probability-map patch sampling (paired, or
stochastic-focal unpaired), HX4-PET SUV to TBR by the patient's
SUVmean-aorta, clip and min-max to [-1, 1]. Outputs channels-last
(D, H, W, C) float32 arrays.

Domain B's patient is drawn with Python's `random` and the patches with
the global `np.random`, as in the JAX project."""

import os
import random
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import pandas as pd

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.utils import sitk_utils

from .utils import patch_samplers
from .utils.basic import apply_body_mask, clip_and_min_max_normalize, sitk2np


@dataclass
class HX4PETTranslationTrainDatasetConfig(configs.base.BaseDatasetConfig):
    paired: bool = True  # `True` only for Pix2Pix
    require_ldct_for_training: bool = False  # `True` only for HX4-CycleGAN-balanced
    hu_range: Tuple[int, int] = (-1000, 2000)
    fdg_suv_range: Tuple[float, float] = (0.0, 15.0)
    hx4_tbr_range: Tuple[float, float] = (0.0, 3.0)
    patch_size: Tuple[int, int, int] = (32, 128, 128)  # DHW
    patch_sampling: str = 'uniform-random-within-body'
    # Focal region proportion applies only to unpaired training.
    focal_region_proportion: Tuple[float, float, float] = (0.6, 0.3, 0.3)  # DHW


def read_suv_aorta_mean_values(root_path):
    """Each patient's HX4 aorta SUVmean, from `SUVmean_aorta_HX4.csv` in the
    parent of the split's root."""
    suv_file = f"{os.path.dirname(root_path)}/SUVmean_aorta_HX4.csv"
    return pd.read_csv(suv_file, index_col=0).to_dict()['HX4 aorta SUVmean baseline']


class HX4PETTranslationTrainDataset:

    def __init__(self, conf):
        dataset_conf = conf.train.dataset
        self.paired = dataset_conf.paired
        self.require_ldct_for_training = dataset_conf.require_ldct_for_training

        root_path = dataset_conf.root
        self.patient_ids = sorted(os.listdir(root_path))

        self.image_paths = {'FDG-PET': [], 'pCT': [], 'HX4-PET': [],
                            'body-mask-A': [], 'body-mask-B': []}
        if self.require_ldct_for_training:
            self.image_paths['ldCT'] = []

        for p_id in self.patient_ids:
            paths = {
                'FDG-PET': f"{root_path}/{p_id}/fdg_pet.nrrd",
                'pCT': f"{root_path}/{p_id}/pct.nrrd",
                'body-mask-A': f"{root_path}/{p_id}/pct_body.nrrd",
            }
            if self.paired:
                paths['HX4-PET'] = f"{root_path}/{p_id}/hx4_pet_reg.nrrd"
                paths['body-mask-B'] = paths['body-mask-A']
            else:
                paths['HX4-PET'] = f"{root_path}/{p_id}/hx4_pet.nrrd"
                paths['body-mask-B'] = f"{root_path}/{p_id}/ldct_body.nrrd"
            if self.require_ldct_for_training:
                paths['ldCT'] = f"{root_path}/{p_id}/ldct.nrrd"
            for k in self.image_paths:
                self.image_paths[k].append(paths[k])

        self.num_datapoints_A = len(self.image_paths['FDG-PET'])
        self.num_datapoints_B = len(self.image_paths['HX4-PET'])

        # SUVmean_aorta values normalize HX4-PET SUV to TBR.
        self.suv_aorta_mean_values = read_suv_aorta_mean_values(root_path)

        self.hu_min, self.hu_max = dataset_conf.hu_range
        self.fdg_suv_min, self.fdg_suv_max = dataset_conf.fdg_suv_range
        self.hx4_tbr_min, self.hx4_tbr_max = dataset_conf.hx4_tbr_range

        patch_size = np.array(dataset_conf.patch_size)
        if self.paired:
            self.patch_sampler = patch_samplers.PairedPatchSampler3D(
                patch_size, dataset_conf.patch_sampling)
        else:
            self.patch_sampler = patch_samplers.UnpairedPatchSampler3D(
                patch_size, dataset_conf.patch_sampling,
                dataset_conf.focal_region_proportion)

    def __len__(self):
        return max(self.num_datapoints_A, self.num_datapoints_B)

    def __getitem__(self, index):
        index_A = index % self.num_datapoints_A
        index_B = index_A if self.paired else random.randint(0, self.num_datapoints_B - 1)

        images_A = {
            'FDG-PET': sitk_utils.load(self.image_paths['FDG-PET'][index_A]),
            'pCT': sitk_utils.load(self.image_paths['pCT'][index_A]),
            'body-mask': sitk_utils.load(self.image_paths['body-mask-A'][index_A]),
        }
        images_B = {
            'HX4-PET': sitk_utils.load(self.image_paths['HX4-PET'][index_B]),
            'body-mask': sitk_utils.load(self.image_paths['body-mask-B'][index_B]),
        }
        if self.require_ldct_for_training:
            images_B['ldCT'] = sitk_utils.load(self.image_paths['ldCT'][index_B])

        images_A = apply_body_mask(sitk2np(images_A))
        images_B = apply_body_mask(sitk2np(images_B))

        images_A, images_B = self.patch_sampler.get_patch_pair(images_A, images_B)

        # Normalize HX4-PET SUV to TBR, then clip + scale all to [-1, 1].
        patient_id = self.patient_ids[index_B]
        images_B['HX4-PET'] = images_B['HX4-PET'] / self.suv_aorta_mean_values[patient_id]

        images_A['FDG-PET'] = clip_and_min_max_normalize(
            images_A['FDG-PET'], self.fdg_suv_min, self.fdg_suv_max)
        images_A['pCT'] = clip_and_min_max_normalize(
            images_A['pCT'], self.hu_min, self.hu_max)
        images_B['HX4-PET'] = clip_and_min_max_normalize(
            images_B['HX4-PET'], self.hx4_tbr_min, self.hx4_tbr_max)
        if self.require_ldct_for_training:
            images_B['ldCT'] = clip_and_min_max_normalize(
                images_B['ldCT'], self.hu_min, self.hu_max)

        # Channels-last stacks: A = [FDG-PET, pCT], B = [HX4-PET(, ldCT)].
        A = np.stack((images_A['FDG-PET'], images_A['pCT']), axis=-1)
        if self.require_ldct_for_training:
            B = np.stack((images_B['HX4-PET'], images_B['ldCT']), axis=-1)
        else:
            B = images_B['HX4-PET'][..., None]

        return {'A': A.astype(np.float32), 'B': B.astype(np.float32)}
