"""``DictFact.set_params`` mid-run hooks of the port against modl_tpu's.

A windowed JAX ``DictFact`` is prepared and streamed over a few batches,
its state is carried into the port (``convert.state_from_jax``), and the
same ``set_params`` call is applied in both packages. The rebuilt
configuration must equal ``config_from_jax`` of the JAX one, and the
migrated D and B must be equal bit for bit at float64 (the re-layout
only copies columns): a changed window width (strip and re-pad), an
unchanged width, a width too wide for windows (warning, back to logical
feature order and gather subsets), the Gram upgrade ``G_agg='full'``
(one product each: 1e-12) and the lazy 'average' allocation.
"""
import numpy as np
import pytest

from modl_tpu import DictFact as JaxDictFact
from modl_tpu_torch import DictFact
from torch_parity import planted, port_config, port_state, to_np

KW = dict(n_components=6, reduction=6, code_alpha=1e-3, code_l1_ratio=0,
          random_state=0, batch_size=50)


def _carried(subset_sampling='window'):
    """A streamed JAX estimator and the port estimator carrying its
    state, configuration and feature order."""
    X = planted()
    df = JaxDictFact(subset_sampling=subset_sampling, **KW)
    df.prepare(n_samples=400, X=X)
    df.partial_fit(X[:200], np.arange(200))
    assert df._cfg.windowed
    port = DictFact(subset_sampling=subset_sampling, device='cpu', **KW)
    port.prepare(n_samples=400, X=X)
    port._state = port_state(df)
    port._feat_perm, port._feat_inv = df._feat_perm, df._feat_inv
    assert port._cfg == port_config(df)
    return df, port, X


def _assert_same_layout(df, port):
    assert port._cfg == port_config(df)
    for name in ('D', 'B'):
        np.testing.assert_array_equal(to_np(getattr(port._state, name)),
                                      np.asarray(getattr(df._state, name)),
                                      err_msg=name)


@pytest.mark.parametrize('subset_sampling', ['window', 'window-ordered'])
@pytest.mark.parametrize('reduction', [4, 6.0])
def test_reduction_moves_the_window_layout(subset_sampling, reduction):
    df, port, X = _carried(subset_sampling)
    old_width = port._state.D.shape[1]
    df.set_params(reduction=reduction)
    port.set_params(reduction=reduction)
    _assert_same_layout(df, port)
    assert port._cfg.windowed
    assert (port._state.D.shape[1] != old_width) == (reduction == 4)
    # the fit goes on at the new width
    port.partial_fit(X[200:300], np.arange(200, 300))
    assert port._state.D.shape == (6, 480 + port._cfg.len_max)


@pytest.mark.parametrize('subset_sampling', ['window', 'window-ordered'])
def test_too_wide_window_falls_back_to_gather(subset_sampling):
    df, port, X = _carried(subset_sampling)
    with pytest.warns(UserWarning, match='falling back to gather'):
        df.set_params(reduction=2)
    with pytest.warns(UserWarning, match='falling back to gather'):
        port.set_params(reduction=2)
    _assert_same_layout(df, port)
    assert not port._cfg.windowed and port._feat_perm is None
    assert port._state.D.shape == (6, 480)
    np.testing.assert_array_equal(port.components_, df.components_)
    port.partial_fit(X[200:300], np.arange(200, 300))
    assert np.isfinite(port.components_).all()


def test_gram_upgrade_recomputes_the_gram():
    df, port, X = _carried()
    assert port._state.G is None
    df.set_params(G_agg='full', Dx_agg='average')
    port.set_params(G_agg='full', Dx_agg='average')
    assert port._cfg == port_config(df)
    assert port._cfg.G_agg == 'full' and port.G_agg == 'full'
    np.testing.assert_allclose(to_np(port._state.G),
                               np.asarray(df._state.G), rtol=0, atol=1e-12)
    # the Gram is that of the logical dictionary (mirror pad excluded)
    D = port.components_
    np.testing.assert_allclose(to_np(port._state.G), D @ D.T, atol=1e-12)
    assert to_np(port._state.Dx_avg).shape == (400, 6)
    port.partial_fit(X[200:300], np.arange(200, 300))
    assert np.isfinite(port.components_).all()


def test_average_state_is_allocated_lazily():
    df, port, X = _carried()
    assert port._state.Dx_avg is None and port._state.G_avg is None
    df.set_params(Dx_agg='average', G_agg='average')
    port.set_params(Dx_agg='average', G_agg='average')
    assert port._cfg == port_config(df)
    for name, shape in (('Dx_avg', (400, 6)), ('G_avg', (400, 6, 6))):
        got = to_np(getattr(port._state, name))
        want = np.asarray(getattr(df._state, name))
        assert got.shape == want.shape == shape and got.dtype == want.dtype
        assert not got.any()
    port.partial_fit(X[200:300], np.arange(200, 300))
    assert to_np(port._state.G_avg)[200:300].any()


def test_set_params_before_prepare_only_sets():
    port = DictFact(device='cpu', **KW)
    port.set_params(G_agg='full', reduction=3)
    assert port.G_agg == 'full' and port.reduction == 3
    assert not hasattr(port, '_cfg')
    port.set_params(mesh=None)      # a parameter since meshes are ported
    with pytest.raises(ValueError, match='invalid parameter'):
        port.set_params(no_such_parameter=None)
