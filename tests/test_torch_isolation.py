"""The port stands alone: ``multiverso_tpu_torch`` imports neither ``jax``
nor the JAX package, and runs on the card unless asked for the CPU."""

import ast
import os
import subprocess
import sys

import pytest

import _torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "multiverso_tpu_torch")


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _py_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    scripts = os.path.join(REPO, "scripts")
    for f in sorted(os.listdir(scripts)):
        if f.startswith(("torch_", "_torch_")) and f.endswith(".py"):
            yield os.path.join(scripts, f)


def test_no_jax_or_jax_package_imports_in_the_source():
    bad = []
    files = list(_py_files())
    assert len(files) > 25
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "multiverso_tpu"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, multiverso_tpu_torch, multiverso_tpu_torch.interop\n"
            "import multiverso_tpu_torch.apps.word2vec_main\n"
            "import multiverso_tpu_torch.models.word2vec\n"
            "import multiverso_tpu_torch.ops.rows, multiverso_tpu_torch.ops.sgns\n"
            "import multiverso_tpu_torch.ops.attention\n"
            "import multiverso_tpu_torch.parallel.sequence\n"
            "import multiverso_tpu_torch.parallel.expert\n"
            "import multiverso_tpu_torch.models.attention_lm\n"
            "import multiverso_tpu_torch.serving\n"
            "import multiverso_tpu_torch.serving.batcher\n"
            "import multiverso_tpu_torch.serving.client\n"
            "import multiverso_tpu_torch.serving.continuous\n"
            "import multiverso_tpu_torch.serving.device_clock\n"
            "import multiverso_tpu_torch.serving.paged\n"
            "import multiverso_tpu_torch.serving.pipeline\n"
            "import multiverso_tpu_torch.serving.quant\n"
            "import multiverso_tpu_torch.serving.runners\n"
            "import multiverso_tpu_torch.serving.service\n"
            "import multiverso_tpu_torch.telemetry.context\n"
            "import multiverso_tpu_torch.telemetry.flight\n"
            "import multiverso_tpu_torch.core.actor\n"
            "import multiverso_tpu_torch.parallel.net\n"
            "import multiverso_tpu_torch.apps._runner\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'multiverso_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


def test_collecting_the_port_tests_loads_no_torch():
    """The port's test modules load torch from fixtures only, so a test
    worker that runs only JAX tests never has torch in its process."""
    mods = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "tests"))
                  if f.startswith("test_torch_") and f.endswith(".py"))
    assert len(mods) >= 6
    code = ("import sys\n"
            f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'multiverso_tpu_torch')]\n"
            "assert not bad, bad[:5]\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


@pytest.fixture
def no_cuda(monkeypatch):
    torch = _torch_port.load_torch()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    yield
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.utils.configure import reset_flags
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        zoo.stop()
    Zoo._reset_for_tests()
    reset_flags()


def test_init_raises_without_cuda_unless_cpu_is_asked(no_cuda):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.utils.log import FatalError
    with pytest.raises(FatalError, match="no CUDA device"):
        mv.init([])
    mv.shutdown()
    with pytest.raises(FatalError, match="unknown -platform"):
        mv.init(["-platform=tpu"])
    mv.shutdown()
    mv.init(["-platform=cpu"])
    t = mv.create_table(mv.ArrayTableOption(size=3))
    assert t.store.data.device.type == "cpu"
    mv.shutdown()


def test_cli_raises_without_cuda_unless_cpu_is_asked(no_cuda, tmp_path):
    from multiverso_tpu_torch.apps import word2vec_main
    corpus = tmp_path / "c.txt"
    corpus.write_text("a b c a b c\n" * 20)
    args = [f"-train_file={corpus}", f"-output_file={tmp_path / 'v.txt'}",
            "-size=8", "-min_count=1", "-batch_size=64",
            "-block_sentences=8", "-pad_sentence_length=8"]
    assert word2vec_main.main(args) == 1             # no card: refused
    assert not (tmp_path / "v.txt").exists()
    assert word2vec_main.main(args + ["-w2v_device=cpu"]) == 0
    assert (tmp_path / "v.txt").read_text().startswith("3 8\n")


def test_bfloat16_runs_without_ml_dtypes():
    """bfloat16 tables and a bfloat16 sg-ns block (the B5 wrapper's plain
    version on the CPU) run where numpy has no bfloat16: the card's
    machine has no ``ml_dtypes``, which here only ``jax`` loads."""
    code = ("import sys\n"
            "sys.modules['ml_dtypes'] = None\n"
            "import numpy as np, torch\n"
            "try:\n"
            "    np.dtype('bfloat16')\n"
            "    raise SystemExit('numpy knows bfloat16')\n"
            "except TypeError:\n"
            "    pass\n"
            "import multiverso_tpu_torch as mv\n"
            "from multiverso_tpu_torch.models.word2vec import (\n"
            "    Dictionary, Word2Vec, Word2VecConfig)\n"
            "mv.init(['-platform=cpu'])\n"
            "d, zipf = Dictionary.synthetic_zipf(50, 5000)\n"
            "rng = np.random.default_rng(0)\n"
            "sents = [rng.choice(50, 12, p=zipf) for _ in range(8)]\n"
            "w = Word2Vec(Word2VecConfig(\n"
            "    embedding_size=8, batch_size=16, param_dtype='bfloat16',\n"
            "    device_pipeline=True, block_sentences=8,\n"
            "    pad_sentence_length=12, dispatch_mode='pallas_grid'), d)\n"
            "assert w.input_table.store.data.dtype == torch.bfloat16\n"
            "s = w.train(sentences=sents)\n"
            "assert np.isfinite(s['loss']) and s['pairs'] > 0, s\n"
            "assert w.embeddings().dtype == np.float32\n"
            "t = mv.create_table(mv.MatrixTableOption(4, 3, "
            "dtype='bfloat16'))\n"
            "t.add_rows([1, 1], np.ones((2, 3), np.float32))\n"
            "assert t.get()[1, 0] == 2.0\n"
            "mv.shutdown()\n"
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            "m.split('.')[0] in ('jax', 'jaxlib', 'multiverso_tpu', "
            "'ml_dtypes')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")
