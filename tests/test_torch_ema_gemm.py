"""The port's EMA-GEMM segment end against modl_tpu's Pallas kernel.

- ``ema_accumulate_reference`` (and the wrapper, which takes it for CPU
  tensors) against ``modl_tpu.ops.ema_gemm.ema_accumulate`` run in
  interpret mode with ``ENABLED`` on, as tests/test_ema_gemm.py runs it.
  The Pallas kernel's dot is a single bf16 pass, so the inputs are
  rounded to bf16-exact values first and the two products agree to f32
  roundoff (1e-5);
- the gate is off by default and asks for float32;
- ``somf_scan`` with the segment end routed through ``ema_accumulate``
  equals the ``addmm_`` path at float64 (1e-12: mul-then-add against a
  fused beta).
The Hopper kernel itself runs only on the card (chip_smoke.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import modl_tpu.ops.ema_gemm as jeg
from modl_tpu import DictFact as JaxDictFact
from modl_tpu_torch import DictFact
from modl_tpu_torch.decomposition import _step
from modl_tpu_torch.ops import bcd, ema_gemm
from torch_parity import clone_state, planted, port_state, to_np


@pytest.fixture(autouse=True)
def interpret_mode():
    old = jeg.INTERPRET, jeg.ENABLED
    jeg.INTERPRET = True
    jeg.ENABLED = True
    yield
    jeg.INTERPRET, jeg.ENABLED = old


def _bf16_exact(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return _bf16_exact(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize('pi', [0.0, 0.75, 1.0])
@pytest.mark.parametrize('k,n,m', [(8, 256, 8), (64, 700, 48),
                                   (16, 300, 24)])
def test_matches_pallas_kernel(k, n, m, pi):
    B, SC, X = _rand((k, n), 0), _rand((m, k), 1), _rand((m, n), 2)
    want = np.asarray(jeg.ema_accumulate(B, SC, X, np.float32(pi)))
    launches = ema_gemm.LAUNCHES
    for fn in (ema_gemm.ema_accumulate_reference, ema_gemm.ema_accumulate):
        Bt = torch.tensor(B)
        out = fn(Bt, torch.tensor(SC), torch.tensor(X), pi)
        assert out is Bt                          # in place
        np.testing.assert_allclose(to_np(out), want, rtol=1e-5, atol=1e-5)
    assert ema_gemm.LAUNCHES == launches          # CPU: no kernel launch


def test_gate_is_off_by_default():
    assert ema_gemm.ENABLED is False
    assert not ema_gemm.supported(1024, 210_780, 1200, torch.float32)


def test_gate_asks_for_float32(monkeypatch):
    monkeypatch.setattr(ema_gemm, 'ENABLED', True)
    assert ema_gemm.supported(1024, 210_780, 1200, torch.float32)
    # ragged and tiny shapes: no k % 8 or VMEM rule on Hopper
    assert ema_gemm.supported(37, 1000, 13, torch.float32)
    assert not ema_gemm.supported(1024, 210_780, 1200, torch.float64)
    assert not ema_gemm.supported(1024, 210_780, 1200, torch.bfloat16)
    assert not ema_gemm.supported(0, 210_780, 1200, torch.float32)


def test_routed_segment_end_matches_addmm(monkeypatch):
    X = planted()
    kw = dict(n_components=6, reduction=6, code_alpha=1e-3, code_l1_ratio=0,
              random_state=0, batch_size=50, subset_sampling='window')
    df = JaxDictFact(**kw)
    df.prepare(n_samples=400, X=X)
    port = DictFact(device='cpu', **kw)
    port.prepare(n_samples=400, X=X)
    port._feat_perm, port._feat_inv = df._feat_perm, df._feat_inv
    st0 = port_state(df)
    # the kernel gates are opened on the CPU at float64, so both runs take
    # the plain BCD and the only difference is the segment end
    monkeypatch.setattr(bcd, 'supported', lambda k, s, dtype: True)
    monkeypatch.setattr(ema_gemm, 'supported',
                        lambda k, n, m, dtype: ema_gemm.ENABLED)
    cfg = dataclasses.replace(port._cfg, use_kernel=True)
    Xw = port._ingest_features(torch.tensor(X))
    T, b = 8, 50
    seg = _step._deferred_seg(cfg, T)
    assert 2 <= seg < T
    rng = np.random.RandomState(3)
    draws = _step.Draws(
        subsets=rng.randint(0, 480, T).tolist(),
        sizes=np.clip(rng.binomial(480, cfg.len_subset / 480, T), 1,
                      cfg.len_max).tolist(),
        orders=torch.as_tensor(np.stack([rng.permutation(6)
                                         for _ in range(T)])))
    calls = []
    real = ema_gemm.ema_accumulate

    def spy(B, SC, Xseg, pi):
        calls.append((tuple(SC.shape), tuple(Xseg.shape)))
        return real(B, SC, Xseg, pi)

    monkeypatch.setattr(ema_gemm, 'ema_accumulate', spy)
    out = {}
    for enabled in (False, True):
        monkeypatch.setattr(ema_gemm, 'ENABLED', enabled)
        out[enabled] = _step.somf_scan(
            clone_state(st0), Xw.reshape(T, b, -1),
            torch.arange(400).reshape(T, b), cfg, draws)
    n_seg = -(-T // seg)
    assert len(calls) == n_seg
    assert calls[0] == ((seg * b, 6), (seg * b, Xw.shape[1]))
    for name in ('B', 'D', 'C', 'comp_norm'):
        np.testing.assert_allclose(to_np(getattr(out[True], name)),
                                   to_np(getattr(out[False], name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    assert to_np(out[True].B).any()
