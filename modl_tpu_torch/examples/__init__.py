"""The repository's ``examples/`` on the port.

Each runs as ``python -m modl_tpu_torch.examples.<name>`` with the
options of its ``examples/`` counterpart, and its ``main()`` takes the
same arguments plus ``device`` (``'cuda'``: the fits run on the card;
``'cpu'`` runs them on the host). Without the real data each falls back,
as its counterpart does, to synthetic records, images or ratings.
"""
