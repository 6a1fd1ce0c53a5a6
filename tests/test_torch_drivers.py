"""The port's drivers (``modl_tpu_torch.examples`` and
``modl_tpu_torch.exps``) against the repository's ``examples/`` and
``exps/`` scripts, on the CPU at tiny sizes.

- every module of the port imports where jax, modl_tpu, scikit-learn,
  joblib, pandas, matplotlib, nibabel and nilearn cannot be imported
  (the card's machine has none of the optional ones);
- each driver's ``main()`` takes its script's arguments, plus ``device``
  (default ``'cuda'``) where it fits an estimator, and without a card
  the default raises instead of running on the CPU;
- ``unmask_hcp`` and ``unmask_adhd`` write the same manifest and the same
  records, bit for bit, as the ``exps/`` scripts on the same inputs;
- ``decompose_hcp`` at k=16 ends below its initial objective, and feeds
  ``DictFact`` the rows and windows that ``modl_tpu``'s fMRIDictFact
  takes under the same masker;
- every example and experiment script runs to its end with
  ``device='cpu'``. The image drivers run on a 32 x 32 synthetic image
  (``source='lisboa'`` with no file there takes the synthetic fallback;
  'face' would download scipy's image).
"""
import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import modl_tpu.decomposition.dict_fact as jdf
import modl_tpu.decomposition.fmri as jfmri
import modl_tpu.input_data.fmri as jin
import modl_tpu_torch.datasets.image as tdimage
import modl_tpu_torch.decomposition.dict_fact as tdf
from modl_tpu_torch.decomposition.fmri import fMRIDictFact
from modl_tpu_torch.examples import (decompose_fmri,
                                     decompose_fmri_stability,
                                     decompose_images, predict_recsys,
                                     stability_selection)
from modl_tpu_torch.exps import (exp_decompose_fmri, exp_decompose_images,
                                 gather_decompose_fmri,
                                 gather_decompose_images,
                                 multi_decompose_fmri, multi_decompose_images,
                                 unmask_adhd)
from modl_tpu_torch.exps.hcp import decompose_hcp, unmask_hcp
from modl_tpu_torch.input_data.fmri import get_raw_rest_data
from test_torch_fmri import _spy

REPO = Path(__file__).resolve().parents[1]
OPTIONAL = ('jax', 'modl_tpu', 'sklearn', 'joblib', 'pandas', 'matplotlib',
            'nibabel', 'nilearn')

EXAMPLES = {'decompose_fmri': decompose_fmri,
            'decompose_fmri_stability': decompose_fmri_stability,
            'decompose_images': decompose_images,
            'predict_recsys': predict_recsys,
            'stability_selection': stability_selection}
PIPELINES = {'exps/hcp/unmask_hcp.py': unmask_hcp,
             'exps/hcp/decompose_hcp.py': decompose_hcp,
             'exps/unmask_adhd.py': unmask_adhd,
             'exps/gather_decompose_fmri.py': gather_decompose_fmri,
             'exps/gather_decompose_images.py': gather_decompose_images}
ON_THE_HOST = (unmask_hcp, unmask_adhd, gather_decompose_fmri,
               gather_decompose_images)


def _script(rel, monkeypatch):
    """A script of the repository's ``examples/`` or ``exps/``, loaded
    from its file (they put their directory on ``sys.path``)."""
    monkeypatch.setattr(sys, 'path', list(sys.path))
    monkeypatch.syspath_prepend(str(REPO / Path(rel).parent))
    name = 'script_' + rel.replace('/', '_')[:-3]
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _shrink(monkeypatch, exp, **small):
    """Every run of ``exp`` with ``small`` laid over its config updates:
    the sweeps set their own grid sizes, too large for the CPU."""
    real = exp.run
    monkeypatch.setattr(exp, 'run', lambda config_updates=None: real(
        config_updates=dict(config_updates or {}, **small)))


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """Outputs and data under the test's directory, which is also the
    working directory (the image drivers save their plots there)."""
    monkeypatch.setenv('MODL_OUTPUT', str(tmp_path / 'out'))
    monkeypatch.setenv('MODL_DATA', str(tmp_path / 'data'))
    monkeypatch.delenv('MODL_SHARED_DATA', raising=False)
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.fixture
def small_image(monkeypatch):
    real = tdimage.make_synthetic_image
    monkeypatch.setattr(tdimage, 'make_synthetic_image',
                        lambda h, w, **kw: real(32, 32, **kw))


def test_every_module_imports_without_the_optional_packages():
    code = (
        "import importlib, importlib.abc, pkgutil, sys\n"
        f"BLOCKED = {OPTIONAL!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import modl_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    modl_tpu_torch.__path__, 'modl_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'modl_tpu_torch.plotting.image' in names\n"
        "assert 'modl_tpu_torch.exps.hcp.decompose_hcp' in names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, '-c', code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) > 60


def test_drivers_take_the_scripts_arguments(monkeypatch):
    def params(fn):
        return {name: p.default
                for name, p in inspect.signature(fn).parameters.items()}

    for rel, module in [(f'examples/{name}.py', module)
                        for name, module in EXAMPLES.items()] \
            + list(PIPELINES.items()):
        want = params(_script(rel, monkeypatch).main)
        got = params(module.main)
        if module not in ON_THE_HOST:
            assert got.pop('device') == 'cuda', rel
        assert got == want, rel
    for rel, module in (('exps/exp_decompose_fmri.py', exp_decompose_fmri),
                        ('exps/exp_decompose_images.py',
                         exp_decompose_images)):
        want = _script(rel, monkeypatch).exp._config_fn()
        got = module.exp._config_fn()
        assert got.pop('device') == 'cuda'
        assert got == want, rel
    for module in (multi_decompose_fmri, multi_decompose_images):
        assert params(module.main) == {'n_jobs': 1, 'device': 'cuda'}


def test_drivers_need_a_card_unless_asked_for_the_cpu(dirs, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('needs a machine without a CUDA device')
    with pytest.raises(RuntimeError, match='no CUDA'):
        stability_selection.main(n_components_list=(2,), n_runs=1)
    # a sweep logs a run that fails on its parameters and goes on, but a
    # device failure ends it
    monkeypatch.setattr(multi_decompose_fmri, 'REDUCTIONS', [4])
    _shrink(monkeypatch, multi_decompose_fmri.exp, n_components=4,
            n_epochs=1, n_subjects=2, test_subjects=1)
    with pytest.raises(RuntimeError, match='no CUDA'):
        multi_decompose_fmri.main()
    _shrink(monkeypatch, multi_decompose_fmri.exp, method='no such')
    assert multi_decompose_fmri.main(device='cpu') == [None]


def _manifest(path, root):
    with open(path) as f:
        text = f.read()
    return json.loads(text.replace(str(root), '<out>'))


def _same_output(tmp_path, monkeypatch, run_jax, run_port, sub):
    out = {}
    for name, run in (('jax', run_jax), ('port', run_port)):
        root = tmp_path / name
        monkeypatch.setenv('MODL_OUTPUT', str(root))
        run()
        out[name] = (root, _manifest(root / 'unmasked' / sub / 'data.json',
                                     root))
    (jroot, want), (proot, got) = out['jax'], out['port']
    assert got == want
    files = sorted(p.name for p in (jroot / 'unmasked' / sub).iterdir())
    assert files == sorted(p.name for p in (proot / 'unmasked' / sub)
                           .iterdir())
    for name in files:
        a, b = (root / 'unmasked' / sub / name for root in (jroot, proot))
        if name == 'data.json':       # compared above, paths aside
            continue
        if name.endswith('-error'):   # tracebacks: the same error
            assert a.read_text().splitlines()[-1] == \
                b.read_text().splitlines()[-1]
            continue
        assert (jroot / 'unmasked' / sub / name).read_bytes() == \
            (proot / 'unmasked' / sub / name).read_bytes(), name
    return got, files


@pytest.mark.parametrize('source', [False, True])
def test_unmask_hcp_matches_the_script(tmp_path, monkeypatch, source):
    src = None
    if source:
        src = tmp_path / 'volumes'
        src.mkdir()
        rng = np.random.RandomState(0)
        mask = rng.rand(5, 4, 3) > 0.3
        np.save(src / 'mask.npy', mask)
        for i in range(2):
            np.save(src / f'subject_{i}.npy',
                    rng.randn(5, 4, 3, 12).astype(np.float32))
        src = str(src)
    script = _script('exps/hcp/unmask_hcp.py', monkeypatch)
    manifest, files = _same_output(
        tmp_path, monkeypatch, lambda: script.main(source_dir=src),
        lambda: unmask_hcp.main(source_dir=src), 'hcp')
    assert 'feature_order.npy' in files
    # every .npy of the source is taken as a record: the mask fails
    assert ('record_0-error' in files) == source
    assert len(manifest['records']) == (2 if source else 4)


def test_unmask_adhd_matches_the_script(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'nilearn', None)
    script = _script('exps/unmask_adhd.py', monkeypatch)
    manifest, _ = _same_output(tmp_path, monkeypatch, script.main,
                               unmask_adhd.main, 'adhd')
    assert len(manifest['records']) == 8


def test_decompose_hcp_lowers_its_objective(dirs):
    assert decompose_hcp.main(device='cpu') is None    # no records yet
    unmask_hcp.main()
    fd = decompose_hcp.main(n_components=16, device='cpu')
    masker, records = get_raw_rest_data(
        str(dirs / 'out' / 'unmasked' / 'hcp'))
    init = fMRIDictFact(method='masked', n_components=16, reduction=20,
                        batch_size=200, learning_rate=0.92, alpha=1e-4,
                        n_epochs=0, mask=masker, standardize=False,
                        detrend=False, random_state=0,
                        device='cpu').fit(records)
    saved = np.load(dirs / 'out' / 'hcp_components.npy')
    assert saved.shape == (16, masker.n_voxels_) == fd.components_.shape
    np.testing.assert_array_equal(saved, fd.components_)
    assert fd.dict_fact_._cfg.windowed    # the records' voxel order kept
    assert fd.score(records) < init.score(records)



def test_decompose_hcp_feeds_the_rows_of_modl_tpu(dirs, monkeypatch):
    """The driver passes the manifest's masker whole (``exps/`` passes
    ``masker.mask_img_``). Under the same masker and settings,
    ``modl_tpu``'s fMRIDictFact draws the same windows and is fed the
    same rows (1e-10) and sample indices (exact)."""
    unmask_hcp.main()
    calls = {'jax': [], 'port': []}
    _spy(monkeypatch, jdf.DictFact, calls['jax'])
    _spy(monkeypatch, tdf.DictFact, calls['port'])
    port = decompose_hcp.main(n_components=16, device='cpu')
    jmasker, records = jin.get_raw_rest_data(
        str(dirs / 'out' / 'unmasked' / 'hcp'))
    ref = jfmri.fMRIDictFact(method='masked', n_components=16, reduction=20,
                             batch_size=200, learning_rate=0.92, alpha=1e-4,
                             n_epochs=1, mask=jmasker, standardize=False,
                             detrend=False, random_state=0).fit(records)
    assert port.dict_fact_._cfg.windowed and ref.dict_fact_._cfg.windowed
    assert len(calls['port']) == len(calls['jax']) == len(records)
    for (X, idx), (X_ref, idx_ref) in zip(calls['port'], calls['jax']):
        np.testing.assert_allclose(X, X_ref, rtol=1e-10, atol=1e-10)
        assert idx is None and idx_ref is None
    assert port.components_.shape == ref.components_.shape

@pytest.mark.parametrize('name', sorted(EXAMPLES))
def test_example_runs(dirs, small_image, name):
    kw = {'decompose_fmri': dict(n_components=5, n_epochs=1),
          'decompose_fmri_stability': dict(n_components_list=(3,),
                                           n_runs=2),
          'decompose_images': dict(source='lisboa', n_components=8,
                                   patch_size=4, n_epochs=1, plot=True),
          'predict_recsys': dict(n_components=5, n_epochs=1),
          'stability_selection': dict(n_components_list=(2, 4),
                                      n_runs=2)}[name]
    out = EXAMPLES[name].main(device='cpu', **kw)
    if isinstance(out, dict):                     # the stability examples
        assert all(np.isfinite(v).all() for v in out.values())
    else:
        assert np.isfinite(out.components_).all()
    if name == 'decompose_images':
        assert (dirs / 'components.png').is_file()


def test_fmri_experiments_run(dirs, monkeypatch):
    small = dict(n_components=4, n_epochs=1, n_subjects=2, test_subjects=1)
    run = exp_decompose_fmri.run(device='cpu', **small)
    assert np.isfinite(run.info['final_score'])
    assert os.path.isfile(os.path.join(run.dir, 'components.npy'))
    monkeypatch.setattr(multi_decompose_fmri, 'REDUCTIONS', [2, 4])
    _shrink(monkeypatch, multi_decompose_fmri.exp, **small)
    scores = multi_decompose_fmri.main(device='cpu')
    table = gather_decompose_fmri.main()
    assert [row[1] for row in table] == [2, 4]
    assert [row[3] for row in table] == scores and all(
        np.isfinite(scores))


def test_image_experiments_run(dirs, small_image, monkeypatch):
    small = dict(source='lisboa', n_components=8, patch_size=4,
                 test_size=100, n_epochs=1)
    run = exp_decompose_images.run(device='cpu', **small)
    assert np.isfinite(run.info['final_score'])
    monkeypatch.setattr(multi_decompose_images, 'REDUCTIONS', [4])
    monkeypatch.setattr(multi_decompose_images, 'METHODS',
                        ['masked', 'gram'])
    _shrink(monkeypatch, multi_decompose_images.exp, **small)
    scores = multi_decompose_images.main(device='cpu')
    table = gather_decompose_images.main(plot=True)
    assert [row[3] for row in table] == scores and all(np.isfinite(scores))
    assert (dirs / 'gather_decompose_images.png').is_file()
