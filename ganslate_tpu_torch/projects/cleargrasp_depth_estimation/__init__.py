"""The port's twin of `projects/cleargrasp_depth_estimation/`: RGB and
surface normal maps to depth maps on ClearGrasp image folders, with the
multimodal CycleGAN whose generators are conditioned on the RGB photo."""
