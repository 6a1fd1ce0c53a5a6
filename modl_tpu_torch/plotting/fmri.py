"""Spatial-map plotting (counterpart of ``modl_tpu/plotting/fmri.py``).

``display_maps`` draws with nilearn's ``plot_prob_atlas`` where nilearn
is installed and takes the image; otherwise it tiles the middle axial
slice of each map of a 4-D (x, y, z, k) array with matplotlib.
"""
import numpy as np

__all__ = ["display_maps"]


def display_maps(fig, components_img, index=0):
    try:
        from nilearn import plotting
        fig.subplots_adjust(top=0.8)
        plotting.plot_prob_atlas(components_img, view_type="filled_contours",
                                 figure=fig)
        return fig
    except Exception:
        pass
    vol = np.asarray(components_img)
    if vol.ndim != 4:
        raise ValueError('expected a 4-D (x, y, z, k) component stack')
    k = vol.shape[3]
    z = vol.shape[2] // 2
    side = int(np.ceil(np.sqrt(k)))
    for i in range(k):
        ax = fig.add_subplot(side, side, i + 1)
        ax.imshow(vol[:, :, z, i], interpolation='nearest')
        ax.set_xticks(())
        ax.set_yticks(())
    return fig
