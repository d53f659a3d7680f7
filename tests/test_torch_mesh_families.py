"""The moe, vlm, encdec and ssm families' sharded prefill and decode bundles
on a mesh of 4 gloo ranks on the CPU, against the JAX package's unsharded
prefill and decode (``tests/test_torch_mesh_steps.py`` holds the dense and
hybrid families so).

Sharding does not change JAX's result, so the JAX side runs unsharded in
the test process: ``prefill`` over a prompt of 16 tokens (B = 4, a cache of
32; phi-3-vision's 8 stub image rows come first, whisper's encoder reads 16
stub frames) and 4 ``decode_step``s, on params it makes, wq and wk tamed
(``_tame``).  The port's side runs in a subprocess that spawns 4 ranks
(this file is its ``__main__``) over a ``file://`` rendezvous under the
test's ``tmp_path``, each with one intra-op thread; past
``test_torch_mesh_steps.RUN_TIMEOUT`` its process group is killed.  Each
rank places the params by the bundle's ``in_shardings``, runs the bundles
with ``attention_impl="pallas"`` (K1 and K2 in their ``local_map`` islands;
the plain versions on the CPU), and rank 0 reports: the logits' and the
full cache's largest differences from JAX's (tolerance 2e-4, f32), each
cache leaf's placements (held against JAX's ``cache_pspecs`` converted),
and the bytes reduced over the mesh (``sharding.relayout.reduced_bytes``).

The cases: granite-moe-smoke (4 experts, top 2: 2 experts a rank) under
``tp`` and ``fsdp_tp`` on (2, 2), and with 3 experts under ``tp`` on (2,
2), where 3 does not divide "model": every rank runs every expert and
the combine needs no reduction (production granite-moe's 40 experts on a
"model" axis of 16 take this path); moonshot-smoke (4 experts and a shared one: 1
expert a rank) under ``tp`` on (1, 4); phi-3-vision-smoke under
``tp`` and ``fsdp_tp`` on (2, 2); whisper-smoke under ``tp`` on (2, 2) and,
with 2 heads, on (1, 4), where its caches (the cross K/V too) are sharded on
head_dim and the cross-attention's scores are a partial sum reduced over
"model"; xlstm-smoke under ``tp`` on (2, 2).

In this process: the MoE layer's ``"dropping"`` and ``"dense"`` routes on a
(1, 1) gloo mesh give ``mesh=None``'s output, aux and grads.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)
from test_torch_mesh_steps import _run_ranks, one_rank  # noqa: F401  (a fixture)

TOL = 2e-4
B, PROMPT, MAX_LEN, STEPS = 4, 16, 32, 4

# (arch, strategy, mesh, config overrides on both sides, see smoke_config)
CASES = {
    "granite-moe-tp-2x2": ("granite-moe-3b-a800m", "tp", (2, 2), {}),
    "granite-moe-fsdp_tp-2x2": ("granite-moe-3b-a800m", "fsdp_tp", (2, 2), {}),
    "granite-moe-3experts-tp-2x2": ("granite-moe-3b-a800m", "tp", (2, 2),
                                    {"moe": {"n_experts": 3}}),
    "moonshot-tp-1x4": ("moonshot-v1-16b-a3b", "tp", (1, 4), {}),
    "phi3v-tp-2x2": ("phi-3-vision-4.2b", "tp", (2, 2), {}),
    "phi3v-fsdp_tp-2x2": ("phi-3-vision-4.2b", "fsdp_tp", (2, 2), {}),
    "whisper-tp-2x2": ("whisper-large-v3", "tp", (2, 2), {}),
    "whisper-2heads-tp-1x4": ("whisper-large-v3", "tp", (1, 4),
                              {"n_heads": 2, "n_kv_heads": 2}),
    "xlstm-tp-2x2": ("xlstm-125m", "tp", (2, 2), {}),
}


def smoke_config(get_smoke_config, arch: str, over: dict):
    """``get_smoke_config`` (the reference's or the port's) of ``arch`` with
    ``over``, whose "moe" entry replaces fields of the MoE config."""
    over = dict(over)
    moe = over.pop("moe", None)
    cfg = get_smoke_config(arch, **over)
    return cfg if moe is None else dataclasses.replace(cfg,
                                                       moe=dataclasses.replace(cfg.moe, **moe))


# ---------------------------------------------------------------------------
# The ranks (run as ``python tests/test_torch_mesh_families.py <work dir>``)
# ---------------------------------------------------------------------------


def _rank(rank: int, work: str) -> None:
    import torch.distributed as dist

    from repro_torch import sharding as SH
    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import params_from_numpy, tree_paths, tree_unflatten
    from repro_torch.steps import make_decode_step, make_prefill_step

    torch.set_num_threads(1)
    job = json.loads((Path(work) / "job.json").read_text())
    data = np.load(Path(work) / "data.npz")
    (d, m), n = job["mesh"], job["mesh"][0] * job["mesh"][1]
    dist.init_process_group("gloo", init_method=f"file://{work}/rdv", rank=rank, world_size=n)
    try:
        mesh = make_local_mesh(d, m, device="cpu")
        cfg = smoke_config(get_smoke_config, job["arch"],
                           {"attention_impl": "pallas", **job["over"]})
        pre = make_prefill_step(cfg, mesh, ShapeConfig("p", MAX_LEN, B, "prefill"),
                                job["strategy"])
        dec = make_decode_step(cfg, mesh, ShapeConfig("d", MAX_LEN, B, "decode"),
                               job["strategy"])
        leaves = [data[f"param{i}"] for i in range(job["n_params"])]
        params = params_from_numpy(tree_unflatten(TF.model_defs(cfg, max_seq=MAX_LEN), leaves),
                                   "cpu", mesh, pre.in_shardings[0])
        prompt = {k[len("prompt:"):]: torch.from_numpy(data[k]) for k in data.files
                  if k.startswith("prompt:")}
        out = {"logits": [], "placements": {}}
        try:  # a batch placed otherwise is refused
            pre.fn(params, prompt)
            out["refused"] = False
        except ValueError:
            out["refused"] = True
        SH.relayout.reduced_bytes = 0
        logits, cache = pre.fn(params, SH.distribute(prompt, mesh, pre.in_shardings[1]))
        out["logits"].append(float(np.abs(logits.numpy() - data["want0"]).max()))
        for path, t in tree_paths(cache):
            out["placements"][path] = [str(p) for p in t.placements]
        for i in range(STEPS):
            batch = SH.distribute({"tokens": torch.from_numpy(data[f"step{i}"])}, mesh,
                                  dec.in_shardings[2])
            logits, cache = dec.fn(params, cache, batch)
            out["logits"].append(float(np.abs(logits.numpy() - data[f"want{i + 1}"]).max()))
        out["reduced_bytes"] = SH.relayout.reduced_bytes
        out["cache"] = {path: float(np.abs(t.full_tensor().numpy() - data[f"cache:{path}"]).max())
                        for path, t in tree_paths(cache)}
        if rank == 0:
            (Path(work) / "result.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _main(work: str) -> None:
    import torch.multiprocessing as mp

    job = json.loads((Path(work) / "job.json").read_text())
    mp.spawn(_rank, args=(work,), nprocs=job["mesh"][0] * job["mesh"][1])


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


def _tame(jp, jcfg):
    """The reference's params with wq and wk of every attention module (self,
    cross, the encoder's) rescaled to std 1/sqrt(d_model), so the scores are
    O(1); the xlstm blocks have none.  At the reference's draw (wk at std 1)
    the scores run in the tens to hundreds, and a one-ulp change of whisper's
    frames moves its 2-head case's logits by 3.6e-4 within 4 steps: more than
    the tolerance, so no sum taken in another order (a head_dim shard's) could
    be held to it."""
    import jax.numpy as jnp

    def tamed(attn):
        attn = dict(attn)
        for name, heads in (("wq", jcfg.n_heads), ("wk", jcfg.n_kv_heads)):
            w = attn[name]
            attn[name] = (w.astype(jnp.float32) * np.sqrt(heads / jcfg.d_model)).astype(w.dtype)
        return attn

    out = dict(jp)
    for stack in ("blocks", "enc_blocks"):
        if isinstance(jp.get(stack), dict):
            out[stack] = dict(jp[stack], **{m: tamed(jp[stack][m]) for m in ("attn", "cross")
                                            if m in jp[stack]})
    return out


def _prompt(jcfg, rng):
    """The prompt's inputs: tokens, and the stub frontend's image rows (vlm)
    or frames (encdec), standard normal in f32."""
    out = {"tokens": rng.integers(0, jcfg.vocab, (B, PROMPT)).astype(np.int32)}
    if jcfg.family == "vlm":
        out["img_embeds"] = rng.standard_normal((B, jcfg.n_img_tokens, jcfg.d_model),
                                                dtype=np.float32)
    if jcfg.family == "encdec":
        out["enc_frames"] = rng.standard_normal((B, jcfg.enc_frames, jcfg.d_model),
                                                dtype=np.float32)
    return out


def _jax_side(arch, over, mesh_shape, work: Path):
    """JAX's numbers on the case's inputs, written for the ranks; returns
    (the job, JAX's cache placements on the mesh as strings, the config)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh

    from repro import sharding as JSH
    from repro.configs.base import get_smoke_config
    from repro.models import decoding as JDEC
    from repro.models import params as JP
    from repro.models import transformer as JTF
    from repro_torch import sharding as TSH

    jcfg = smoke_config(get_smoke_config, arch, over)
    jp = _tame(JP.init_params(jax.random.PRNGKey(3), JTF.model_defs(jcfg, max_seq=MAX_LEN)),
               jcfg)
    rng = np.random.default_rng(7)
    prompt = _prompt(jcfg, rng)
    arrays = {f"prompt:{k}": v for k, v in prompt.items()}
    logits, cache = JDEC.prefill(jp, jcfg, {k: jnp.asarray(v) for k, v in prompt.items()},
                                 MAX_LEN)
    arrays["want0"] = np.asarray(logits)
    for i in range(STEPS):
        arrays[f"step{i}"] = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
        logits, cache = JDEC.decode_step(jp, jcfg, cache, jnp.asarray(arrays[f"step{i}"]))
        arrays[f"want{i + 1}"] = np.asarray(logits)
    for path, leaf in jax.tree_util.tree_leaves_with_path(cache):
        arrays[f"cache:{jax.tree_util.keystr(path)}"] = np.asarray(leaf)
    leaves = jax.tree_util.tree_leaves(jp)
    for i, leaf in enumerate(leaves):
        arrays[f"param{i}"] = np.asarray(leaf)
    np.savez(work / "data.npz", **arrays)
    amesh = AbstractMesh(mesh_shape, ("data", "model"))
    jspecs = JSH.cache_pspecs(jcfg, JDEC.cache_specs(jcfg, B, MAX_LEN), amesh)
    layout = dict(zip(("data", "model"), mesh_shape))
    want = {jax.tree_util.keystr(path): [str(p) for p in TSH.placements(TSH.P(*spec), layout)]
            for path, spec in jax.tree_util.tree_leaves_with_path(
                jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    return {"n_params": len(leaves)}, want, jcfg


@pytest.mark.parametrize("case", list(CASES))
def test_family_prefill_and_decode_on_a_mesh_match_jax(case, tmp_path):
    arch, strategy, mesh_shape, over = CASES[case]
    job, want_placements, jcfg = _jax_side(arch, over, mesh_shape, tmp_path)
    job.update(arch=arch, strategy=strategy, mesh=list(mesh_shape), over=over)
    (tmp_path / "job.json").write_text(json.dumps(job))
    _run_ranks(tmp_path, __file__)
    got = json.loads((tmp_path / "result.json").read_text())
    assert got["refused"], "a batch of plain tensors was not refused"
    assert max(got["logits"]) <= TOL, got["logits"]
    assert len(got["logits"]) == 1 + STEPS
    assert sorted(got["cache"]) == sorted(want_placements)
    assert max(got["cache"].values()) <= TOL, got["cache"]
    assert got["placements"] == want_placements
    if jcfg.family == "moe" and jcfg.moe.e_pad % mesh_shape[1] == 0:  # experts over "model"
        assert got["reduced_bytes"] > 0  # one reduction
    if over.get("n_kv_heads") == 2:  # the cross K/V on head_dim: the scores' reduction
        assert got["placements"]["['cross_k']"] == ["R", "S(4)"]
        assert got["reduced_bytes"] > 0


@pytest.mark.parametrize("routing", ["dropping", "dense"])
def test_moe_layer_on_a_one_rank_mesh_matches_no_mesh(routing, one_rank):
    """The MoE layer (moonshot-smoke: 4 experts, top 2, a shared expert) on
    DTensors of a (1, 1) gloo mesh, placed by the rules under ``fsdp_tp``:
    ``"dropping"`` through its dispatch island, ``"dense"`` with its experts
    gathered whole.  The output, the aux and every grad equal ``mesh=None``'s
    (one rank runs the same local arithmetic)."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch import sharding as SH
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import init_params, tree_map, tree_paths

    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, routing_impl=routing))
    defs = MOE.moe_defs(cfg)
    params = init_params(defs, torch.Generator().manual_seed(4), "cpu")
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(5))

    def run(p, xs):
        p = tree_map(lambda t: t.detach().requires_grad_(True), p)
        out, aux = MOE.apply_moe(p, xs, cfg)
        (out.float().square().sum() + aux).backward()
        full = (lambda t: t.full_tensor()) if isinstance(out, DTensor) else (lambda t: t)
        return full(out), full(aux), {path: full(t.grad) for path, t in tree_paths(p)}

    want = run(params, x)
    mesh = make_local_mesh(1, 1, device="cpu")
    specs = SH.param_pspecs(defs, SH.make_rules(mesh, "fsdp_tp"), mesh)
    got = run(SH.distribute(params, mesh, specs),
              SH.distribute(x, mesh, SH.P("data", None, None)))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)
    assert sorted(got[2]) == sorted(want[2])
    for path, g in got[2].items():
        torch.testing.assert_close(g, want[2][path], rtol=0, atol=1e-6, msg=path)


if __name__ == "__main__":
    _main(sys.argv[1])
