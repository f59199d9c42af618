"""The port's checkpoints, trainer and training launcher, on the CPU.

Checkpoints use the JAX package's on-disk format, so they move both ways:

* a JAX-written checkpoint (f32 SMOKE params + ``AdamWState``, and a bf16
  leaf) restores into the port bit for bit; a port-written one (f32)
  restores into JAX bit for bit, with the same manifest keys, files and
  dtypes;
* the reference's bf16 fault: JAX's own ``restore_pytree`` raises on the
  bf16 file it wrote, which the port reads correctly (ROADMAP queue 3);
* keep-N rotation, a partial ``.tmp`` directory never trusted, the async
  round trip and its error raised on the next ``wait()``;
* ``Trainer``: exact resume after a restart (losses equal to an
  uninterrupted run's), the emergency checkpoint on a crash, the straggler
  hook, ``remesh``/``mesh=`` on a 1 x 1 mesh (multi-GPU worlds:
  ``test_torch_mesh_train.py``);
  the twins of ``tests/test_runtime.py``'s trainer tests;
* ``launch.train --smoke --device cpu`` run twice resumes;
* ``benchmarks.common``: a few subject steps restore from their cache, and
  ``evaluate`` matches the JAX substrate's within 1e-5.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import get_smoke_config as jax_smoke
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_pytree, save_pytree)
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticCorpus, batch_iterator
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.runtime import Trainer, TrainerConfig

torch.set_num_threads(1)


def _jax_state():
    jm = jreg.build(jax_smoke("llama2-7b"))
    jp = jm.init(jax.random.key(0))
    js = jadamw.init(jp)
    # one update, so the moments and the step are not zeros
    g = jax.tree.map(lambda x: jnp.full_like(x, 0.01), jp)
    jp, js, _ = jax.jit(lambda p, g, s: jadamw.apply(
        jadamw.AdamWConfig(), p, g, s))(jp, g, js)
    return {"params": jp, "opt": js}


def _template():
    shapes = registry.build(get_smoke_config("llama2-7b")).init(0, "meta")
    return {"params": shapes, "opt": adamw.init(shapes)}


def _pairs(jtree, ttree):
    """(key, jax leaf, port leaf) over the JAX flatten order."""
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    for path, leaf in flat:
        node = ttree
        for p in path:
            node = (node[p.key] if hasattr(p, "key")
                    else getattr(node, p.name))
        yield "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path), leaf, node


# ------------------------------------------------------------------ format
def test_jax_checkpoint_restores_bit_exact(tmp_path):
    js = _jax_state()
    jckpt.save_pytree(js, str(tmp_path), 4, extra={"note": "jax"})
    tree, manifest = restore_pytree(_template(), str(tmp_path))
    assert manifest["step"] == 4 and manifest["extra"] == {"note": "jax"}
    n = 0
    for key, jl, tl in _pairs(js, tree):
        assert tl.device.type == "cpu"
        assert str(tl.dtype).replace("torch.", "") == str(jl.dtype), key
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl),
                                      err_msg=key)
        n += 1
    assert n == len(manifest["leaves"]) and int(tree["opt"].step) == 1


def test_port_checkpoint_restores_into_jax_bit_exact(tmp_path):
    js = _jax_state()
    tree = {"params": bridge.params_from_numpy(
                jax.tree.map(np.asarray, js["params"]), "cpu"),
            "opt": adamw.AdamWState(
                torch.tensor(1, dtype=torch.int32),
                bridge.params_from_numpy(jax.tree.map(np.asarray,
                                                      js["opt"].mu), "cpu"),
                bridge.params_from_numpy(jax.tree.map(np.asarray,
                                                      js["opt"].nu), "cpu"))}
    save_pytree(tree, str(tmp_path / "port"), 4)
    jckpt.save_pytree(js, str(tmp_path / "jax"), 4)
    man = {w: json.load(open(tmp_path / w / "step_0000000004"
                             / "manifest.json")) for w in ("port", "jax")}
    assert man["port"] == man["jax"]
    assert list(man["port"]["leaves"]) == list(man["jax"]["leaves"])
    back, _ = jckpt.restore_pytree(jax.eval_shape(lambda: js),
                                   str(tmp_path / "port"))
    for key, jl, tl in _pairs(back, tree):
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy(),
                                      err_msg=key)


def _bf16_tree():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((2, 3)), jnp.bfloat16)
    return {"a": a, "opt": jadamw.init({"a": a})}


def test_bf16_leaf_round_trips_in_the_jax_format(tmp_path):
    """A bf16 leaf as JAX writes it (two-byte void, dtype "bfloat16") reads
    back bit for bit, and the port writes the same records."""
    jt = _bf16_tree()
    jckpt.save_pytree(jt, str(tmp_path / "jax"), 1)
    tmpl = {"a": torch.empty(2, 3, dtype=torch.bfloat16, device="meta")}
    tmpl["opt"] = adamw.init(tmpl)
    got, manifest = restore_pytree(tmpl, str(tmp_path / "jax"))
    assert manifest["leaves"]["a"]["dtype"] == "bfloat16"
    assert got["a"].dtype == torch.bfloat16
    want_bits = np.asarray(jt["a"]).view(np.uint16)
    np.testing.assert_array_equal(got["a"].view(torch.uint16).numpy(),
                                  want_bits)
    save_pytree(got, str(tmp_path / "port"), 1)
    raw = {w: np.load(tmp_path / w / "step_0000000001" / "a.npy")
           for w in ("jax", "port")}
    assert raw["port"].dtype.itemsize == raw["jax"].dtype.itemsize == 2
    assert raw["port"].dtype.kind == raw["jax"].dtype.kind == "V"
    np.testing.assert_array_equal(raw["port"].view(np.uint16),
                                  raw["jax"].view(np.uint16))
    back, _ = restore_pytree(tmpl, str(tmp_path / "port"))
    assert torch.equal(back["a"], got["a"])


def test_jax_bf16_checkpoint_fault_is_recorded(tmp_path):
    """ROADMAP queue 3: the reference cannot restore a bf16 leaf it wrote
    (``np.load`` gives two-byte void records, and ``astype(bfloat16)`` has
    no cast from them); the port reads the same files correctly."""
    jt = _bf16_tree()
    jckpt.save_pytree(jt, str(tmp_path), 1)
    with pytest.raises(ValueError, match="No cast function"):
        jckpt.restore_pytree(jax.eval_shape(lambda: jt), str(tmp_path))
    tmpl = {"a": torch.empty(2, 3, dtype=torch.bfloat16)}
    tmpl["opt"] = adamw.init(tmpl)
    got, _ = restore_pytree(tmpl, str(tmp_path))
    np.testing.assert_array_equal(got["a"].float().numpy(),
                                  np.asarray(jt["a"], np.float32))


# ------------------------------------------------------------------ manager
def _params():
    return registry.build(get_smoke_config("llama2-7b")).init(0, "cpu")


def test_checkpoint_atomic_and_keep_n(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    p = _params()
    for s in (1, 2, 3):
        cm.save(p, s)
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_0000000002", "step_0000000003"]
    assert cm.latest_step() == 3


def test_checkpoint_roundtrip_async(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    p = _params()
    cm.save(p, 7, blocking=False)
    cm.wait()
    restored, manifest = cm.restore(
        registry.build(get_smoke_config("llama2-7b")).init(0, "meta"))
    assert manifest["step"] == 7
    flat = lambda t: ([x for v in t.values() for x in flat(v)]
                      if isinstance(t, dict) else [t])
    for a, b in zip(flat(p), flat(restored)):
        assert torch.equal(a, b)


def test_async_write_error_surfaces_on_wait(tmp_path, monkeypatch):
    from repro_torch.checkpoint import manager

    def full_disk(*_):
        raise OSError("no space left on device")

    cm = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(manager, "_write", full_disk)
    cm.save({"x": torch.ones(2)}, 1, blocking=False)
    with pytest.raises(OSError, match="no space"):
        cm.wait()
    cm.wait()                           # the error was raised once
    monkeypatch.undo()
    cm.save({"x": torch.ones(2)}, 2, blocking=False)
    cm.wait()
    assert cm.latest_step() == 2


def test_checkpoint_ignores_partial_writes(tmp_path):
    save_pytree(_params(), str(tmp_path), 5)
    os.makedirs(tmp_path / "step_0000000009.tmp")
    assert latest_step(str(tmp_path)) == 5


# ------------------------------------------------------------------ trainer
def _small_trainer(tmp_path, steps=12, ckpt_every=4, ckpt_async=False):
    model = registry.build(get_smoke_config("llama2-7b").replace(n_layers=2))
    return model, Trainer(
        model, adamw.AdamWConfig(lr=1e-3, total_steps=steps),
        TrainerConfig(total_steps=steps, ckpt_dir=str(tmp_path),
                      ckpt_every=ckpt_every, log_every=1,
                      ckpt_async=ckpt_async, remat=False), device="cpu")


def test_trainer_checkpoint_restart_resumes_exactly(tmp_path):
    model, ref = _small_trainer(tmp_path / "ref")
    corpus = SyntheticCorpus(model.cfg.vocab_size, seed=1)
    want = ref.run(batch_iterator(corpus, 2, 32))["history"]
    model, tr = _small_trainer(tmp_path / "run", ckpt_async=True)
    tr.run(batch_iterator(corpus, 2, 32), steps=8)
    assert tr.ckpt.latest_step() == 8
    # a fresh trainer = a restart after a node failure
    _, tr2 = _small_trainer(tmp_path / "run")
    assert tr2.maybe_restore() and tr2.step == 8
    out = tr2.run(batch_iterator(corpus, 2, 32, start=tr2.step))
    assert out["final_step"] == 12 and tr2.ckpt.latest_step() == 12
    got = {h["step"]: h["loss"] for h in out["history"]}
    assert got == {h["step"]: h["loss"] for h in want if h["step"] > 8}


def test_trainer_emergency_checkpoint_on_crash(tmp_path):
    model, tr = _small_trainer(tmp_path, steps=100, ckpt_every=1000)
    corpus = SyntheticCorpus(model.cfg.vocab_size, seed=1)
    base = batch_iterator(corpus, 2, 32)

    def crashing():
        for i, b in enumerate(base):
            if i == 5:
                raise RuntimeError("simulated node failure")
            yield b

    with pytest.raises(RuntimeError):
        tr.run(crashing())
    assert tr.ckpt.latest_step() == 5   # emergency save happened


def test_trainer_straggler_detection(tmp_path):
    import time
    model, tr = _small_trainer(tmp_path, steps=10, ckpt_every=1000)
    corpus = SyntheticCorpus(model.cfg.vocab_size, seed=1)
    events = []
    tr.on_straggler = lambda s, dt: events.append(s)
    base = batch_iterator(corpus, 2, 32)

    def slow():
        for i, b in enumerate(base):
            if i == 6:
                time.sleep(1.2)   # inject a straggler step
            yield b

    tr.run(slow())
    assert len(tr.straggler_events) >= 1
    assert events == [s for s, _, _ in tr.straggler_events]


def test_trainer_remesh_is_refused(tmp_path):
    """Formerly the refusal pin of multi-GPU training: ``remesh`` and
    ``mesh=`` now work. On a world of one, a run re-meshed onto 1 x 1
    keeps training, and a trainer builds on the mesh."""
    from repro_torch.launch.mesh import destroy_distributed, make_host_mesh
    model, tr = _small_trainer(tmp_path)
    corpus = SyntheticCorpus(model.cfg.vocab_size, seed=1)
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"), device="cpu")
        tr.run(batch_iterator(corpus, 2, 32), steps=3)
        tr.remesh(mesh)
        out = tr.run(batch_iterator(corpus, 2, 32, start=tr.step), steps=3)
        assert out["final_step"] == 6
        assert np.isfinite(out["history"][-1]["loss"])
        meshed = Trainer(model, adamw.AdamWConfig(), TrainerConfig(),
                         mesh=mesh, device="cpu")
        assert meshed.mesh is mesh
    finally:
        destroy_distributed()


# ----------------------------------------------------------------- launcher
def test_train_launcher_resumes_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path)]
    first = train.main(argv + ["--steps", "4"])
    assert first["final_step"] == 4
    assert "resumed" not in capsys.readouterr().out
    second = train.main(argv + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 4" in out
    assert second["final_step"] == 6 and "done at step 6" in out
    # --mesh: the (world, 1) mesh of a world of one, resuming the same run
    third = train.main(argv + ["--steps", "8", "--mesh"])
    out = capsys.readouterr().out
    assert "mesh: {'data': 1, 'model': 1}" in out
    assert "resumed from checkpoint at step 6" in out
    assert third["final_step"] == 8


def test_train_launcher_without_gpu_raises(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--smoke", "--steps", "1"])


# ------------------------------------------------------------ bench common
def test_subject_trains_once_and_evaluates_like_jax(tmp_path, capsys,
                                                     monkeypatch):
    from repro_torch.benchmarks import common
    monkeypatch.setattr(common, "SUBJECT_STEPS", 2)   # 300 on the card
    model, params, corpus = common.subject(device="cpu",
                                           bench_dir=str(tmp_path))
    assert "training subject model 0→2" in capsys.readouterr().out
    _, again, _ = common.subject(device="cpu", bench_dir=str(tmp_path))
    assert "training" not in capsys.readouterr().out
    assert torch.equal(again["embed"], params["embed"])
    assert model.cfg.n_layers == 8 and model.cfg.d_model == 256
    # the JAX substrate's evaluate on the same weights and batches
    from repro.configs.llama2_7b import RAP_SUBJECT as JAX_SUBJECT
    jm = jreg.build(JAX_SUBJECT)
    jp = jax.tree.map(jnp.asarray, _to_numpy(params))
    batches = common.eval_batches(corpus, n_batches=1, bs=2, seq=32,
                                  device="cpu")
    got = common.evaluate(model, params, batches)
    want = _jax_evaluate(jm, jp, [{k: jnp.asarray(v.numpy())
                                   for k, v in b.items()} for b in batches])
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)
    assert got["acc"] == want["acc"]


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _jax_evaluate(model, params, batches):
    """``benchmarks/common.py::evaluate`` of the JAX package (that module
    is a script's, not the package's: its body, here)."""
    tot_nll, tot_correct, tot_tok = 0.0, 0.0, 0
    for b in batches:
        lg = model.logits(params, b)
        lg, labels = lg[:, :-1], b["labels"][:, 1:]
        viota = jax.lax.broadcasted_iota(jnp.int32, (lg.shape[-1],), 0)
        lg = jnp.where(viota >= model.cfg.vocab_size, -1e30, lg)
        logz = jax.nn.logsumexp(lg, axis=-1)
        gold = jnp.sum(jnp.where(viota == labels[..., None], lg, 0.0), -1)
        tot_nll += float(jnp.sum(logz - gold))
        tot_correct += float(jnp.sum(jnp.argmax(lg, -1) == labels))
        tot_tok += labels.size
    return {"ppl": float(np.exp(tot_nll / tot_tok)),
            "acc": tot_correct / tot_tok}
