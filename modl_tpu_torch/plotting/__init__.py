"""Plots of fitted dictionaries (counterpart of ``modl_tpu/plotting``):
``fmri.display_maps`` for spatial maps, ``image.plot_patches`` and
``image.plot_single_patch`` for patch dictionaries. They draw on a
matplotlib figure or axis that the caller makes; nilearn, where it is
installed, draws the maps."""
