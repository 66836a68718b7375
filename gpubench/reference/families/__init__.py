"""The plain reference train steps, one file a GAN family, named by the
short name of the program's GAN class (the last part of
`train.gan._target_`); `CycleGAN.py` says what a family file holds."""
