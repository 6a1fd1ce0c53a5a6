"""Patch-dictionary plotting (counterpart of
``modl_tpu/plotting/image.py``)."""
import numpy as np

__all__ = ["plot_patches", "plot_single_patch"]


def plot_single_patch(ax, patch, x=None, y=None):
    patch = np.squeeze(patch)
    if patch.ndim == 3 and patch.shape[2] not in (3, 4):
        patch = patch[:, :, 0]
    ax.imshow(patch, interpolation='nearest')
    ax.set_xticks(())
    ax.set_yticks(())
    return ax


def plot_patches(fig, patches):
    """The first (at most) 100 patches on a square grid of axes."""
    n = min(len(patches), 100)
    side = int(np.ceil(np.sqrt(n)))
    for i in range(n):
        ax = fig.add_subplot(side, side, i + 1)
        plot_single_patch(ax, patches[i])
    fig.subplots_adjust(wspace=0.05, hspace=0.05)
    return fig
