"""The image workload's fits timed on several checkouts, on one GPU.

    python modl_tpu_torch/benchmarks/ab_image_fit.py TREE [TREE ...]

Each TREE is the root of a checkout of this repo (for example a
``git archive`` of another commit unpacked under ``build/``). For each
TREE, in the order given, a fresh Python process imports that checkout's
``modl_tpu_torch`` (building its kernels), fits ``ImageDictFact`` once as
a warm-up on the image workload's 20,000-patch subset (``workloads.py``:
one epoch, 100 steps of the per-step ``DictFact`` path), then times
``REPEATS`` more fits, then one epoch of the face-size fit (~760k
patches, 3,799 steps). Each timed fit prints one line: the tree, the
fit's wall time, ``time_`` (the time inside the steps), and the steps
the checkout's step program ran and the graphs it captured (``None``
for a checkout without ``decomposition/_program.py``). Give the trees as
A B B A so that a drift of the card or the host hits both alike. Prints
the card's name and power limit first.
"""
import importlib
import os
import subprocess
import sys
import time

REPEATS = 3


def leg(tree):
    """Time the image fits with ``tree``'s package."""
    sys.path[0] = tree
    import torch
    import modl_tpu_torch
    from modl_tpu_torch import ImageDictFact
    from modl_tpu_torch.benchmarks import workloads as wl
    from modl_tpu_torch.datasets.image import make_synthetic_image
    try:
        program = importlib.import_module(
            'modl_tpu_torch.decomposition._program')
    except ImportError:
        program = None

    def counts():
        return ((program.STEPS, program.CAPTURES) if program is not None
                else (None, None))

    print(f'tree={tree} package={modl_tpu_torch.__file__}', flush=True)
    image = make_synthetic_image(*wl.IMAGE_SHAPE)
    fits = [('subset', dict(max_patches=wl.IMAGE_SUBSET))] * (REPEATS + 1)
    for rep, (name, extra) in enumerate(fits + [('face', {})]):
        img = ImageDictFact(**dict(wl.IMAGE, n_epochs=1, **extra),
                            device='cuda')
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img.fit(image)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = counts()
        graph = [None if a is None else a - b
                 for a, b in zip(after, before)]
        if rep:
            print(f'tree={tree} fit={name} wall_s={wall:.4f} '
                  f'steps_s={img.time_:.4f} '
                  f'steps={wl.image_steps(img.n_iter_, img)} '
                  f'graph_steps={graph[0]} captures={graph[1]}',
                  flush=True)
    return 0


def main(argv):
    if argv[:1] == ['--leg']:
        return leg(os.path.abspath(argv[1]))
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in argv:
        tree = os.path.abspath(tree)
        subprocess.run([sys.executable, os.path.abspath(__file__), '--leg',
                        tree], cwd=tree, check=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
