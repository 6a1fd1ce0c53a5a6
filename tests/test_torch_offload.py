"""``average_offload``: G_avg in host RAM, exchanged a segment at a time.

On the CPU ``G_avg`` is plain host memory and the same segmented code
runs as on the card (``_step.offload_scan``), so these tests cover it:

- the offloaded fit equals the resident one bit for bit (the counterpart
  of ``tests/test_offload.py::test_average_offload_matches_resident``,
  which JAX runs only on a TPU). ``OFFLOAD_SEG_BYTES`` is set to two
  batches of G_avg rows, so that an epoch of 7 full batches runs 3
  segments, a leftover batch and a ragged tail;
- segments against ``modl_tpu``'s resident steps from a carried state,
  with injected windows, sizes and orders, at float64;
- repeated sample indices take the per-batch path, with the resident
  result;
- the lazy 'average' allocation of ``set_params`` goes to host memory.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modl_tpu import DictFact as JaxDictFact
from modl_tpu.decomposition import _step as jstep
from modl_tpu_torch import DictFact, convert
from modl_tpu_torch.decomposition import _step, dict_fact
from torch_parity import assert_states_close, planted, port_config, \
    port_state

T = torch.as_tensor
KW = dict(n_components=4, reduction=2, code_alpha=1e-3, comp_l1_ratio=0,
          Dx_agg='average', G_agg='average', n_epochs=2, batch_size=16,
          random_state=0, device='cpu')
LEAVES = ('D', 'B', 'C', 'comp_norm', 'code', 'Dx_avg', 'G_avg',
          'sample_n_iter')


@pytest.fixture
def two_batch_segments(monkeypatch):
    """Segments of two batches of KW's G_avg rows (16 x 4 x 4 float64),
    and a record of the (T, b) shape of every segment run."""
    monkeypatch.setattr(dict_fact, 'OFFLOAD_SEG_BYTES', 2 * 16 * 4 * 4 * 8)
    shapes = []
    run = DictFact._offload_segment

    def spy(self, X_batches, idx_batches):
        shapes.append(tuple(idx_batches.shape))
        return run(self, X_batches, idx_batches)

    monkeypatch.setattr(DictFact, '_offload_segment', spy)
    return shapes


def _assert_same_state(a, b):
    for name in LEAVES:
        x, y = getattr(a._state, name), getattr(b._state, name)
        assert torch.equal(x, y), name
    assert a.n_iter_ == b.n_iter_


def test_offloaded_fit_matches_resident(two_batch_segments):
    X = np.random.RandomState(0).randn(120, 24)
    ref = DictFact(**KW).fit(X)
    off = DictFact(average_offload=True, **KW).fit(X)
    # per epoch: 3 segments of 2 batches, the leftover batch, the tail
    assert two_batch_segments == ([(2, 16)] * 3 + [(1, 16), (1, 8)]) * 2
    assert off._cfg.average_offload and not ref._cfg.average_offload
    _assert_same_state(off, ref)
    np.testing.assert_array_equal(off.components_, ref.components_)
    np.testing.assert_array_equal(off.G_average_, ref.G_average_)
    assert off._state.G_avg.device.type == 'cpu'


def test_windowed_offload_matches_resident_batch_steps(monkeypatch):
    """Windowed subsets: the segments step B's EMA every batch, as the
    resident fit does batch by batch (a callback), bit for bit; the
    resident fused epoch defers it to its segment end (float sums in
    another order)."""
    monkeypatch.setattr(dict_fact, 'OFFLOAD_SEG_BYTES', 2 * 20 * 36 * 8)
    X = np.random.RandomState(5).randn(100, 400)
    kw = dict(KW, n_components=6, reduction=8, batch_size=20,
              comp_l1_ratio=1)

    def each_batch(est):
        pass

    off = DictFact(average_offload=True, **kw).fit(X)
    ref = DictFact(callback=each_batch, **kw).fit(X)
    fused = DictFact(**kw).fit(X)
    assert off._cfg.windowed and _step._deferred_seg(fused._cfg, 5) >= 2
    _assert_same_state(off, ref)
    np.testing.assert_allclose(off.components_, fused.components_,
                               rtol=1e-9, atol=1e-12)


def test_offload_segments_match_jax_resident_steps():
    """Windowed, rand_size: segments of 3, 3 and 2 steps against the JAX
    package's resident step, from the same carried state with the same
    draws (the tolerance of
    ``test_torch_dict_fact.py::test_epoch_matches_jax_from_carried_state``)."""
    X = planted()
    kw = dict(n_components=6, reduction=6, code_alpha=1e-3,
              code_l1_ratio=0, random_state=0, batch_size=50,
              Dx_agg='average', G_agg='average', subset_sampling='window')
    df = JaxDictFact(**kw)
    df.prepare(n_samples=400, X=X)
    cfg = df._cfg
    assert cfg.windowed and cfg.rand_size and not cfg.average_offload
    port = DictFact(average_offload=True, device='cpu', **kw)
    port.prepare(n_samples=400, X=X)
    assert port._cfg == port_config(df, average_offload=True)
    port._feat_perm, port._feat_inv = df._feat_perm, df._feat_inv
    port._state = port_state(df)
    Xw = port._ingest_features(T(X))
    Xw_jax = df._ingest_features(jnp.asarray(X))

    rng = np.random.RandomState(7)
    T_, b = 8, 50
    starts = rng.randint(0, 480, T_).tolist()
    sizes = np.clip(rng.binomial(480, cfg.len_subset / 480, T_), 1,
                    cfg.len_max).tolist()
    orders = np.stack([rng.permutation(6) for _ in range(T_)])
    # a sample order that is not the arange, so local rows are remapped
    perm = rng.permutation(400)

    step = jax.jit(jstep.somf_step_inner, static_argnames='cfg')
    st_jax = df._state
    for t in range(T_):
        rows = perm[t * b:(t + 1) * b]
        st_jax = step(st_jax, Xw_jax[rows], jnp.asarray(rows, jnp.int32),
                      jnp.asarray(starts[t], jnp.int32),
                      jnp.asarray(orders[t], jnp.int32), cfg,
                      n_valid=jnp.asarray(sizes[t], jnp.int32))
    st = port._state
    staging = torch.empty((3 * b, 6, 6), dtype=torch.float64)
    for lo, hi in ((0, 3), (3, 6), (6, 8)):
        idx = T(perm[lo * b:hi * b]).reshape(hi - lo, b)
        draws = _step.Draws(subsets=starts[lo:hi], sizes=sizes[lo:hi],
                            orders=T(orders[lo:hi]))
        st = _step.offload_scan(st, Xw[idx], idx, port._cfg, draws, staging)
    assert_states_close(st, st_jax, ('D', 'B', 'C', 'code', 'comp_norm',
                                     'Dx_avg', 'G_avg'),
                        rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(st.sample_n_iter.numpy(),
                                  np.asarray(st_jax.sample_n_iter))


def test_repeated_indices_step_batch_by_batch(two_batch_segments):
    """A call whose sample indices repeat runs one-batch segments; a
    batch that repeats an index within itself maps both rows to one local
    row, as the resident state would."""
    rng = np.random.RandomState(1)
    X = rng.randn(40, 24)
    idx = np.concatenate([np.arange(16), np.arange(10), [3, 3],
                          np.arange(20, 32)])
    kw = dict(KW, n_epochs=1)
    ref = DictFact(**kw).prepare(n_samples=40, X=X)
    off = DictFact(average_offload=True, **kw).prepare(n_samples=40, X=X)
    for est in (ref, off):
        est.partial_fit(X, sample_indices=idx)
    assert two_batch_segments == [(1, 16), (1, 16), (1, 8)]
    _assert_same_state(off, ref)
    del two_batch_segments[:]
    off.partial_fit(X, sample_indices=np.arange(40))
    ref.partial_fit(X, sample_indices=np.arange(40))
    assert two_batch_segments == [(2, 16), (1, 8)]
    _assert_same_state(off, ref)


def test_lazy_average_allocation_stays_on_host(monkeypatch):
    X = np.random.RandomState(2).randn(48, 24)
    kw = dict(KW, G_agg='masked', Dx_agg='masked')
    allocated = []
    host_zeros = dict_fact.host_zeros

    def spy(shape, dtype, device):
        allocated.append(tuple(shape))
        return host_zeros(shape, dtype, device)

    monkeypatch.setattr(dict_fact, 'host_zeros', spy)
    ests = [DictFact(average_offload=offload, **kw).prepare(n_samples=48,
                                                           X=X)
            for offload in (False, True)]
    for est in ests:
        assert est._state.G_avg is None
        est.partial_fit(X)
        est.set_params(G_agg='average', Dx_agg='average')
        est.partial_fit(X)
    assert allocated == [(48, 4, 4)]
    _assert_same_state(*ests)


def test_offload_needs_a_supported_device():
    assert _step.offload_supported('cpu')
    assert _step.offload_supported(torch.device('cuda', 0))
    assert not _step.offload_supported('meta')
    X = np.random.RandomState(3).randn(16, 8)
    with pytest.raises(ValueError, match='average_offload'):
        DictFact(**dict(KW, average_offload=True, device='meta')).fit(X)


def test_config_from_jax_takes_offload():
    df = JaxDictFact(**{k: v for k, v in KW.items() if k != 'device'})
    df.prepare(n_samples=32, X=np.random.RandomState(4).randn(32, 24))
    cfg = dataclasses.replace(df._cfg, average_offload=True)
    assert convert.config_from_jax(cfg).average_offload
    # a JAX mesh maps onto a port mesh of its shape, made over the
    # initialised process group, which this process has not
    mesh = types.SimpleNamespace(shape={'dp': 2, 'feat': 1})
    with pytest.raises(RuntimeError, match='initialised process group'):
        convert.config_from_jax(dataclasses.replace(cfg, mesh=mesh))
