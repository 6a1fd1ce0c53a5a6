"""The port's ``plotting`` against modl_tpu's, with matplotlib's Agg
backend: the same figures from the same numpy inputs (the same number of
axes, each axis' image array exactly equal), without nilearn and with a
fake ``nilearn.plotting`` installed in ``sys.modules``."""
import sys
import types

import matplotlib

matplotlib.use('Agg')

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import modl_tpu.plotting.fmri as jfmri  # noqa: E402
import modl_tpu.plotting.image as jimage  # noqa: E402
import modl_tpu_torch.plotting.fmri as tfmri  # noqa: E402
import modl_tpu_torch.plotting.image as timage  # noqa: E402


def _images(fig):
    return [np.asarray(ax.images[0].get_array()) for ax in fig.axes]


def _same_figures(draw_port, draw_jax):
    figs = [plt.figure(), plt.figure()]
    try:
        assert draw_port(figs[0]) is figs[0]
        assert draw_jax(figs[1]) is figs[1]
        got, want = _images(figs[0]), _images(figs[1])
        assert len(figs[0].axes) == len(figs[1].axes) == len(got)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return len(got)
    finally:
        for fig in figs:
            plt.close(fig)


@pytest.mark.parametrize('k', [1, 4, 7])
def test_display_maps_without_nilearn(monkeypatch, k):
    monkeypatch.setitem(sys.modules, 'nilearn', None)
    vol = np.random.RandomState(k).randn(6, 5, 4, k)
    assert _same_figures(lambda f: tfmri.display_maps(f, vol),
                         lambda f: jfmri.display_maps(f, vol)) == k


def test_display_maps_through_nilearn(monkeypatch):
    calls = []
    nilearn = types.ModuleType('nilearn')
    nilearn.plotting = types.ModuleType('nilearn.plotting')
    nilearn.plotting.plot_prob_atlas = lambda img, **kw: calls.append(
        (img, kw['view_type'], kw['figure']))
    monkeypatch.setitem(sys.modules, 'nilearn', nilearn)
    monkeypatch.setitem(sys.modules, 'nilearn.plotting', nilearn.plotting)
    img = object()
    for module in (tfmri, jfmri):
        fig = plt.figure()
        assert module.display_maps(fig, img) is fig
        assert calls[-1] == (img, 'filled_contours', fig)
        assert fig.subplotpars.top == 0.8 and not fig.axes
        plt.close(fig)


def test_display_maps_takes_only_4d(monkeypatch):
    monkeypatch.setitem(sys.modules, 'nilearn', None)
    fig = plt.figure()
    for module in (tfmri, jfmri):
        with pytest.raises(ValueError, match='4-D'):
            module.display_maps(fig, np.zeros((3, 3, 3)))
    plt.close(fig)


@pytest.mark.parametrize('shape', [(9, 6, 6, 1), (5, 4, 4, 3), (120, 3, 3),
                                   (4, 5, 5, 2)])
def test_plot_patches_matches_jax(shape):
    patches = np.random.RandomState(0).rand(*shape)
    n = _same_figures(lambda f: timage.plot_patches(f, patches),
                      lambda f: jimage.plot_patches(f, patches))
    assert n == min(shape[0], 100)


def test_plot_single_patch_matches_jax():
    patch = np.random.RandomState(1).rand(4, 4, 3)
    figs = [plt.figure(), plt.figure()]
    axes = [fig.add_subplot(1, 1, 1) for fig in figs]
    assert timage.plot_single_patch(axes[0], patch) is axes[0]
    jimage.plot_single_patch(axes[1], patch)
    np.testing.assert_array_equal(axes[0].images[0].get_array(),
                                  axes[1].images[0].get_array())
    assert not axes[0].get_xticks().size and not axes[0].get_yticks().size
    for fig in figs:
        plt.close(fig)
