"""The port's serving path against the JAX package's, its entry points' device
rule, and the import boundary between the two packages."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.models import params as JP
from repro.models import transformer as JTF
from repro.serving import ServingEngine as JEngine
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.launch import serve
from repro_torch.models.params import params_from_numpy
from repro_torch.serving import ServingEngine
from repro_torch.steps import init_model

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

ROOT = Path(__file__).resolve().parents[1]


# gemma (its ids are the test's older ones), then granite-moe: right-padded
# prompts whose pads route through the experts too, and a first decode that
# re-routes the last prompt token as a group of one
ENGINE_CASES = [pytest.param(arch, impl, id=(f"{arch}-" if arch != "gemma-2b" else "") + impl)
                for arch in ("gemma-2b", "granite-moe-3b-a800m") for impl in ("xla", "pallas")]


@pytest.mark.parametrize("arch,impl", ENGINE_CASES)
def test_engine_greedy_tokens_match_jax_engine(arch, impl):
    """Same carried f32 params, 5 requests through 2 slots (slots refill)."""
    jcfg = j_smoke(arch)
    jp = JP.init_params(jax.random.PRNGKey(0), JTF.model_defs(jcfg))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(20)
    reqs = [([int(t) for t in rng.integers(1, jcfg.vocab, size=n)], new)
            for n, new in [(8, 5), (3, 4), (6, 7), (1, 3), (5, 6)]]
    kw = dict(max_batch=2, max_len=32, prefill_len=8)
    jeng = JEngine(jcfg, jp, **kw)
    teng = ServingEngine(t_smoke(arch, attention_impl=impl), tp, device="cpu", **kw)
    for prompt, new in reqs:
        assert jeng.submit(prompt, max_new_tokens=new) == teng.submit(prompt, max_new_tokens=new)
    want = jeng.run_until_idle()
    got = teng.run_until_idle()
    assert got == want
    assert [len(got[i]) for i in range(5)] == [new for _, new in reqs]
    assert teng.stats == jeng.stats


def test_serve_launcher_runs_on_the_cpu_when_asked(capsys):
    summary = serve.main(["--device", "cpu", "--requests", "3", "--max-batch", "2",
                          "--max-new", "3", "--prefill-len", "8", "--max-len", "16", "--json"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary
    assert summary["completed"] == 3 and summary["tokens"] == 9
    assert summary["device"] == "cpu" and summary["attention_impl"] == "pallas"


def test_moe_serve_launcher_runs_on_the_cpu_when_asked(capsys):
    summary = serve.main(["--arch", "granite-moe-3b-a800m", "--device", "cpu", "--requests",
                          "3", "--max-batch", "2", "--max-new", "3", "--prefill-len", "8",
                          "--max-len", "16", "--json"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert summary["completed"] == 3 and summary["tokens"] == 9


def test_entry_points_raise_without_a_card(monkeypatch):
    """The default device is the card; with no card they raise, never run on
    the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("gemma-2b", "hymba-1.5b", "granite-moe-3b-a800m"):
        cfg = t_smoke(arch)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--arch", arch, "--requests", "1"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_model(cfg)
        _, params = init_model(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServingEngine(cfg, params)


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module and chip_smoke.py import without pulling in
    jax or any module of the JAX package."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 15  # every module was imported


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA, or outside a checkout, chip_smoke.py exits non-zero and
    prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
