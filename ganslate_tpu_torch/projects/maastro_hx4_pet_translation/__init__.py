"""The port's twin of `projects/maastro_hx4_pet_translation/`: FDG-PET and
planning CT to HX4-PET translation on NRRD volumes, with the balanced
CycleGAN whose generators take a PET and a CT channel and emit a PET."""
