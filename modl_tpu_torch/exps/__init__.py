"""The experiment pipelines of the repository's ``exps/`` on the port.

Each module runs as ``python -m modl_tpu_torch.exps.<name>`` (the HCP
pipeline as ``modl_tpu_torch.exps.hcp.<name>``) with the arguments of
its ``exps/`` counterpart, and its ``main()`` takes the same arguments.
Those that fit an estimator run it on the card unless ``device='cpu'``
is passed. Outputs go under ``utils.system.get_output_dir()``
(``MODL_OUTPUT``). Without the real data each falls back, as its
counterpart does, to synthetic records or images.
"""
