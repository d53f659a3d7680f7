"""The moe, vlm, encdec and ssm families' sharded train step on a mesh of 4
gloo ranks on the CPU, against the JAX package's unsharded train step
(``tests/test_torch_mesh_train.py`` holds the dense and hybrid families so,
and this file borrows its comparison).

The JAX side runs in the test process: the reference's ``make_train_step``
on a one-device JAX mesh, from params it makes (every attention module's wq
and wk tamed, as ``tests/test_torch_vlm_encdec.py`` does), on batches made
with numpy from a seed (B = 4, S = 16, part of the mask off; phi-3-vision's
8 stub image rows take 8 of the 16 positions, whisper's encoder reads 16
stub frames).  The port's side runs in a subprocess that spawns 4 ranks
(this file is its ``__main__``) over a ``file://`` rendezvous under the
test's ``tmp_path``, each with one intra-op thread; past ``RUN_TIMEOUT`` its
process group is killed.  Rank 0 writes the metrics of each step, the state
after each step (every param, ``mu`` and ``nu`` leaf gathered whole) and
each leaf's placements.

Each step is held against the reference's step from the same state
(``test_torch_mesh_train._held`` and ``_close_state``'s rule: loss, aux, grad norm and lr
2e-4 relative, the moments 2e-4 of their leaf's max, the params too but for
the elements whose grad is ~0), and the placements after the steps equal
those converted from the reference's ``p_specs`` / ``opt_pspecs``.

The cases, 2 steps each: moonshot-smoke under ``tp`` on (2, 2) with ZeRO-1
(the reference's three-family check, ``tools/parallel_checks.py::
check_sharded_train_step``, trains it so); granite-moe-smoke under
``fsdp_tp`` on (2, 2); phi-3-vision-smoke under ``tp`` on (1, 4) with
ZeRO-1; whisper-smoke under ``tp`` on (2, 2); xlstm-smoke under ``tp`` on
(2, 2) with ZeRO-1; granite-moe-smoke with 3 experts under ``tp`` on (2,
2), where the experts stay whole on every rank: each rank's weight grads
are its batch rows' share of the sum, its activation grads whole.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)
from test_torch_mesh_families import _tame, smoke_config
from test_torch_mesh_train import (B, BATCH_KEYS, OPT, S, _held, _placements, _run_ranks,
                                   _steps, _want_placements)

# (arch, strategy, mesh, ZeRO-1, config overrides on both sides, see smoke_config)
CASES = {
    "moonshot-tp-2x2-zero1": ("moonshot-v1-16b-a3b", "tp", (2, 2), True, {}),
    "granite-moe-fsdp_tp-2x2": ("granite-moe-3b-a800m", "fsdp_tp", (2, 2), False, {}),
    "phi3v-tp-1x4-zero1": ("phi-3-vision-4.2b", "tp", (1, 4), True, {}),
    "whisper-tp-2x2": ("whisper-large-v3", "tp", (2, 2), False, {}),
    "xlstm-tp-2x2-zero1": ("xlstm-125m", "tp", (2, 2), True, {}),
    "granite-moe-3experts-tp-2x2": ("granite-moe-3b-a800m", "tp", (2, 2), False,
                                    {"moe": {"n_experts": 3}}),
}
STUBS = {"vlm": "img_embeds", "encdec": "enc_frames"}  # the stub frontend's input


# ---------------------------------------------------------------------------
# The ranks (run as ``python tests/test_torch_mesh_families_train.py <dir>``)
# ---------------------------------------------------------------------------


def _rank(rank: int, work: str) -> None:
    import torch.distributed as dist

    from repro_torch import sharding as SH
    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import params_from_numpy, tree_unflatten
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.steps import make_train_step

    torch.set_num_threads(1)
    job = json.loads((Path(work) / "job.json").read_text())
    data = np.load(Path(work) / "data.npz")
    keys = tuple(job["keys"])
    dist.init_process_group("gloo", init_method=f"file://{work}/rdv", rank=rank, world_size=4)
    try:
        mesh = make_local_mesh(*job["mesh"], device="cpu")
        cfg = smoke_config(get_smoke_config, job["arch"], job["over"])
        bundle = make_train_step(cfg, mesh, ShapeConfig("t", S, B, "train"),
                                 AdamWConfig(**OPT), job["strategy"], zero1=job["zero1"])
        leaves = [data[f"param{i}"] for i in range(job["n_params"])]
        params = params_from_numpy(tree_unflatten(TF.model_defs(cfg, max_seq=S), leaves),
                                   "cpu", mesh, bundle.in_shardings[0])
        opt = adamw_init(params, bundle.in_shardings[1])
        out, arrays = {"metrics": []}, {}
        try:  # a batch of plain tensors is refused
            bundle.fn(params, opt, {k: torch.from_numpy(data[f"{k}0"]) for k in keys})
            out["refused"] = False
        except ValueError:
            out["refused"] = True
        SH.relayout.reduced_bytes = 0
        params, opt = _steps(bundle, params, opt, data, mesh, 0, 2, out, arrays, keys)
        out["reduced_bytes"] = SH.relayout.reduced_bytes
        out["placements"] = {"params": _placements(params), "mu": _placements(opt["mu"]),
                             "nu": _placements(opt["nu"])}
        if rank == 0:
            np.savez(Path(work) / "got.npz", **arrays)
            (Path(work) / "result.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _main(work: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(work,), nprocs=4)


# ---------------------------------------------------------------------------
# The JAX side and the comparison
# ---------------------------------------------------------------------------


def _batches(jcfg, n):
    """``n`` batches of tokens, targets and mask (S minus the vlm's image
    rows), with the stub frontend's ``img_embeds`` or ``enc_frames``, batch
    i's key k stored as "<k><i>"."""
    rng = np.random.default_rng(11)
    s = S - (jcfg.n_img_tokens if jcfg.family == "vlm" else 0)
    out = {}
    for i in range(n):
        mask = np.ones((B, s), np.float32)
        mask[:, : s // 4] = 0.0
        mask[1, -3:] = 0.0
        out.update({f"tokens{i}": rng.integers(0, jcfg.vocab, (B, s)).astype(np.int32),
                    f"targets{i}": rng.integers(0, jcfg.vocab, (B, s)).astype(np.int32),
                    f"mask{i}": mask})
        rows = {"vlm": jcfg.n_img_tokens, "encdec": jcfg.enc_frames}.get(jcfg.family)
        if rows:
            out[f"{STUBS[jcfg.family]}{i}"] = rng.standard_normal((B, rows, jcfg.d_model),
                                                                  dtype=np.float32)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_family_train_step_on_a_mesh_matches_jax(case, tmp_path):
    """2 steps on the mesh, each within 2e-4 of the reference's step from the
    same state (``test_torch_mesh_train._held``), placed as the
    reference's specs."""
    import jax

    from repro import steps as JS
    from repro.configs.base import get_smoke_config

    arch, strategy, mesh_shape, zero1, over = CASES[case]
    jcfg = smoke_config(get_smoke_config, arch, over)
    jp = _tame(JS.init_model(jcfg, seed=3, max_seq=S)[1], jcfg)
    arrays = _batches(jcfg, 2)
    keys = BATCH_KEYS + ((STUBS[jcfg.family],) if jcfg.family in STUBS else ())
    leaves = jax.tree_util.tree_leaves(jp)
    np.savez(tmp_path / "data.npz", **arrays,
             **{f"param{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)})
    (tmp_path / "job.json").write_text(json.dumps(
        {"n_params": len(leaves), "arch": arch, "strategy": strategy,
         "mesh": list(mesh_shape), "zero1": zero1, "keys": list(keys), "over": over}))
    got = _run_ranks(tmp_path, __file__)
    assert got["refused"], "a batch of plain tensors was not refused"
    assert len(got["metrics"]) == 2
    _held((jcfg, jp, arrays), got["metrics"], dict(np.load(tmp_path / "got.npz")), keys)
    assert got["placements"] == _want_placements(arch, strategy, mesh_shape, zero1, jcfg)
    if mesh_shape == (2, 2):  # the batch is split over "data": the grads are reduced
        assert got["reduced_bytes"] > 0


if __name__ == "__main__":
    _main(sys.argv[1])
