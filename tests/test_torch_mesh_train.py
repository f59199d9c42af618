"""``Trainer(mesh=)``, ``remesh``, checkpoints across meshes and the
compressed train step on multi-process gloo worlds on the CPU (worlds
built as in ``test_torch_mesh_model.py``: spawned, ``FileStore``,
deadlines). Every rank trains the same SMOKE llama2-7b (f32, 2 layers) on
the same batches.

* (2, 1): the data-parallel trainer's losses are the meshless trainer's
  within 1e-6 over 3 steps — also with shards whose token counts differ
  (a ``loss_mask``), where the DP mean is weighted by tokens;
* ``remesh`` from (2, 1) to (1, 2) mid-run keeps training, and the state
  right after it is bitwise the state gathered before it;
* a checkpoint saved on (2, 1), and one on (1, 2), restore bitwise with
  no mesh; on (2, 1), where nothing is cut, a save issues no collective,
  and on (1, 2) the cut leaves are gathered to rank 0 alone;
* ``make_compressed_train_step``: a step on (2, 1) has a finite loss,
  moves the parameters alike on both ranks and leaves residuals.
"""
import numpy as np
import pytest
import torch

from test_torch_mesh_model import run_world

STEPS = 3


def _trainer(mesh, ckpt_dir=None, steps=8):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.runtime import Trainer, TrainerConfig
    model = registry.build(get_smoke_config("llama2-7b").replace(
        n_layers=2, dtype="float32", param_dtype="float32"))
    return model, Trainer(
        model, adamw.AdamWConfig(lr=1e-3, total_steps=steps),
        TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=100,
                      log_every=1, ckpt_async=False, remat=False),
        mesh=mesh, device="cpu")


def _batches(vocab, masked=False, start=0):
    from repro_torch.data import SyntheticCorpus, batch_iterator
    for b in batch_iterator(SyntheticCorpus(vocab, seed=1), 4, 32,
                            start=start):
        if masked:         # rows with different token counts
            m = np.ones_like(b["labels"], np.float32)
            m[0, 20:] = 0.0
            m[3, 5:] = 0.0
            b = dict(b, loss_mask=m)
        yield b


def _losses(summary):
    return [h["loss"] for h in summary["history"]]


def _flat(state):
    from repro_torch.tree import flatten
    return flatten(state)


def _restored(ckpt_dir, want):
    """(restored?, step, leaves that differ) of a meshless trainer
    restoring the latest checkpoint, against the gathered state ``want``."""
    _, fresh = _trainer(None, ckpt_dir=ckpt_dir)
    ok = fresh.maybe_restore()
    got = _flat({"params": fresh.params, "opt": fresh.opt_state})
    return ok, fresh.step, [k for k in want
                            if not torch.equal(want[k], got[k])]


_COLLECTIVES = ("all_gather", "gather", "all_reduce", "broadcast",
                "barrier", "all_gather_into_tensor", "reduce_scatter",
                "send", "recv")


def _counting(fn):
    """(``fn()``, {collective: calls}) with ``torch.distributed``'s
    collectives counted while ``fn`` runs."""
    import torch.distributed as dist
    calls = dict.fromkeys(_COLLECTIVES, 0)
    real = {n: getattr(dist, n) for n in _COLLECTIVES}

    def counted(n):
        def call(*args, **kwargs):
            calls[n] += 1
            return real[n](*args, **kwargs)
        return call

    for n in _COLLECTIVES:
        setattr(dist, n, counted(n))
    try:
        return fn(), calls
    finally:
        for n in _COLLECTIVES:
            setattr(dist, n, real[n])


def _body(rank, world, ckpt_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh
    dp = Mesh((2, 1), ("data", "model"), "cpu")
    out = {}
    for masked in (False, True):
        model, ref = _trainer(None)
        want = _losses(ref.run(_batches(model.cfg.vocab_size, masked),
                               steps=STEPS))
        _, tr = _trainer(dp)
        got = _losses(tr.run(_batches(model.cfg.vocab_size, masked),
                             steps=STEPS))
        out[f"losses_masked={masked}"] = (want, got)
    # a checkpoint on (2, 1), restored with no mesh; then remesh (2, 1) ->
    # (1, 2) mid-run, whose final save restores with no mesh too
    model, tr = _trainer(dp, ckpt_dir=ckpt_dir)
    tr.run(_batches(model.cfg.vocab_size), steps=2)
    out["save_2x1_calls"] = _counting(lambda: tr.save(blocking=True))[1]
    before = _flat(tr.gathered_state())
    dist.barrier()                      # rank 0's write is on disk
    out["restore_2x1"] = _restored(ckpt_dir, before)
    tp_mesh = Mesh((1, 2), ("data", "model"), "cpu")
    tr.remesh(tp_mesh)
    after = _flat(tr.gathered_state())
    out["remesh_bitwise"] = (set(before) == set(after) and all(
        torch.equal(before[k], after[k]) for k in before))
    out["local_shape"] = tuple(tr.params["stacks"]["attn"]["wq"].shape)
    to0, calls = _counting(lambda: tr.gathered_state(dst=0))
    out["gather_to_0"] = (calls, None if to0 is None else all(
        torch.equal(after[k], v) for k, v in _flat(to0).items()))
    more = tr.run(_batches(model.cfg.vocab_size, start=tr.step), steps=2)
    out["after_remesh"] = (more["final_step"], _losses(more))
    final = _flat(tr.gathered_state())
    dist.barrier()
    out["restore_1x2"] = _restored(ckpt_dir, final)
    # one compressed step
    from repro_torch.optim import adamw
    from repro_torch.parallel import compression
    from repro_torch.runtime import steps
    from repro_torch.runtime.trainer import to_device
    params = model.init(0, "cpu")
    opt = adamw.init(params)
    res = compression.init_residuals(params)
    step = steps.make_compressed_train_step(model, adamw.AdamWConfig(), dp,
                                            remat=False)
    batch = to_device(next(_batches(model.cfg.vocab_size)), "cpu")
    new, _, new_res, metrics = step(params, opt, res, batch)
    moved = [float((a.float() - b.float()).abs().max())
             for a, b in zip(_flat(new).values(), _flat(params).values())]
    out["compressed"] = dict(
        loss=float(metrics["loss"]), moved=max(moved),
        residual=max(float(v.abs().max()) for v in _flat(new_res).values()),
        digest=float(sum(v.double().sum() for v in _flat(new).values())))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    return run_world(_body, 2, d, str(d / "ckpt"))


@pytest.mark.parametrize("masked", [False, True])
def test_dp_trainer_gives_meshless_losses(world, masked):
    for rank in world:
        want, got = rank[f"losses_masked={masked}"]
        assert len(got) == STEPS
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert world[0][f"losses_masked={masked}"] == \
        world[1][f"losses_masked={masked}"]


def test_remesh_keeps_state_and_trains(world):
    for rank in world:
        assert rank["remesh_bitwise"]
        assert rank["local_shape"][-1] * 2 == 64      # wq cut over "model"
        final, losses = rank["after_remesh"]
        assert final == 4 and np.all(np.isfinite(losses))
    assert world[0]["after_remesh"] == world[1]["after_remesh"]


def test_mesh_checkpoint_restores_without_mesh(world):
    for rank in world:
        assert rank["restore_2x1"] == (True, 2, [])
        assert rank["restore_1x2"] == (True, 4, [])


def test_mesh_save_gathers_only_cut_leaves_to_the_writer(world):
    for r, rank in enumerate(world):
        assert sum(rank["save_2x1_calls"].values()) == 0   # nothing cut
        calls, whole = rank["gather_to_0"]
        assert calls["gather"] > 0
        assert sum(calls.values()) == calls["gather"]
        assert whole is (True if r == 0 else None)


def test_compressed_train_step(world):
    for rank in world:
        c = rank["compressed"]
        assert np.isfinite(c["loss"]) and c["moved"] > 0
        assert c["residual"] > 0           # each rank's own error
    a, b = world[0]["compressed"], world[1]["compressed"]
    assert (a["loss"], a["digest"]) == (b["loss"], b["digest"])
