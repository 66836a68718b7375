"""The plain reference networks, one file each, named by the short name of
the program's class (the last part of the config's `_target_`). Each file
holds `build(**kwargs)`, the network, and `kwargs(section, label, gan)`,
its arguments read from the network's config section for one direction or
domain. Modules take and return `(N, C, *spatial)`, and their parameters
carry the names of ganslate's checkpoints, so one state dict loads into a
reference network and into the program's alike."""
