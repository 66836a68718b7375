"""The port's twin of `projects/brats_mri_sequence_translation/`: BRaTS MRI
sequence translation (FLAIR to T1w) on 4-D NIfTI volumes."""
