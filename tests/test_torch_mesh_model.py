"""Tensor- and expert-parallel model code and the compressed all-reduce on
multi-process gloo worlds on the CPU.

Each world is ``torch.multiprocessing`` in ``spawn`` mode, its ranks
meeting on a ``FileStore`` under the test's temporary directory (no TCP
port two test workers could both take), every ``init_process_group``
with a 60 s timeout and every world joined against a deadline, after
which its processes are killed and the test fails: a hung collective
fails in about 90 s. Children run one thread each and report their
exceptions back as the test's error. Many checks share one world.

* On a (1, 2) world, every SMOKE architecture in f32 (llama2-7b, gemma-2b
  with one KV head, olmoe-1b-7b and dbrx-132b through the expert-parallel
  FFN, whisper-medium, mamba2-370m, recurrentgemma-9b, ...): logits within
  1e-5 of the single-process forward, loss and every gradient leaf
  (gathered whole) likewise, greedy prefill + decode tokens equal, and two
  runs bitwise equal; also at widths the model axis does not divide
  (``ODD``), where ranks gather the cut leaves and compute whole;
* on a (2, 2) world, ``ShardedExecutor`` serves an engine trace to the
  end, twice, bitwise (the serve tests' helpers);
* on a (2, 1) world, ``compress_allreduce``: each rank's dequantized
  payload and new residual are JAX's ``_quantize`` on that rank's
  gradients, the mean is the ranks' sum over 2, and a second round with
  the residuals carries the error back (``tests/test_runtime.py``'s
  error-feedback check); ``plain_allreduce`` is the f32 mean.
"""
import os
import queue
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch

DEADLINE_S = 90.0

ARCHS = ("llama2-7b", "gemma-2b", "glm4-9b", "qwen3-14b", "qwen1.5-32b",
         "internvl2-1b", "olmoe-1b-7b", "dbrx-132b", "whisper-medium",
         "mamba2-370m", "recurrentgemma-9b")
# widths the model axis does not divide: every rank gathers those blocks
# and computes them whole (3 heads, an odd F under the GLU cut, an odd
# padded vocab; one RG-LRU gate block)
ODD = {"llama2-7b odd": ("llama2-7b", dict(n_heads=3, n_kv_heads=3,
                                           head_dim=16, d_ff=87,
                                           vocab_size=515,
                                           vocab_round_to=1)),
       "recurrentgemma-9b odd": ("recurrentgemma-9b",
                                 dict(n_heads=1, n_kv_heads=1))}


# ------------------------------------------------------------------ worlds
def _child(fn, rank, world, store, q, args):
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        q.put((rank, "ok", fn(rank, world, *args)))
    except Exception:
        q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world: int, tmp_dir, *args, deadline: float = DEADLINE_S):
    """``fn(rank, world, *args)`` on every rank of a fresh gloo world;
    returns the ranks' results in rank order, or fails with every rank's
    traceback (or the ranks that did not report before the deadline)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(str(tmp_dir), f"store-{time.time_ns()}")
    procs = [ctx.Process(target=_child, args=(fn, r, world, store, q, args))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    got = {}
    try:
        while len(got) < world:
            left = end - time.monotonic()
            if left <= 0:
                break
            try:
                rank, status, out = q.get(timeout=min(left, 1.0))
            except queue.Empty:
                if not any(p.is_alive() for p in procs) and q.empty():
                    break
                continue
            got[rank] = (status, out)
    finally:
        for p in procs:
            p.join(max(0.1, min(end - time.monotonic(), 5.0)))
            if p.is_alive():
                p.kill()
                p.join()
    errors = [f"rank {r}:\n{out}" for r, (s, out) in sorted(got.items())
              if s != "ok"]
    if errors:
        pytest.fail("\n".join(errors), pytrace=False)
    if len(got) < world:
        pytest.fail(f"ranks {sorted(set(range(world)) - set(got))} of "
                    f"{world} did not report within {deadline:.0f} s "
                    f"(killed)", pytrace=False)
    return [got[r][1] for r in range(world)]


def _f32(arch):
    from repro_torch.configs import get_smoke_config
    base, extra = ODD.get(arch, (arch, {}))
    return get_smoke_config(base).replace(dtype="float32",
                                          param_dtype="float32", **extra)


# ---------------------------------------------------- tensor parallel model
def _tp_body(rank, world, archs):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import decoder, encdec, registry
    from repro_torch.parallel import activation as act
    from repro_torch.parallel import sharding, tp
    from repro_torch.runtime import steps
    from repro_torch.tree import flatten
    mesh = Mesh((1, world), ("data", "model"), "cpu")
    out = {}
    for arch in archs:
        cfg = _f32(arch)
        model = registry.build(cfg)
        params = model.init(0, "cpu")
        specs = sharding.param_pspecs(params, mesh)
        local = sharding.shard_params(params, specs, mesh, mesh.coords, cfg)
        g = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
        batch = {"tokens": toks, "labels": toks}
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.randn(2, cfg.n_audio_frames, cfg.d_model,
                                          generator=g)

        def greedy(p):
            """Prefill + 4 greedy decode steps: the tokens [B, 5]."""
            if cfg.is_encoder_decoder:
                logits, cache = encdec.prefill(p, cfg, toks, batch["frames"],
                                               32)
                first = torch.argmax(logits, -1).to(torch.int32)
                seq, tok = [first], first[:, None]
                for _ in range(4):
                    lg, cache = encdec.decode_step(p, cfg, cache, tok)
                    tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
                    seq.append(tok[:, 0])
                return torch.stack(seq, 1)
            logits, cache = decoder.prefill(p, cfg, toks, 32)
            first = torch.argmax(logits, -1).to(torch.int32)
            rest, _ = decoder.decode_horizon(p, cfg, cache, first[:, None], 4)
            return torch.cat([first[:, None], rest], 1)

        with torch.no_grad():
            ref_logits = model.logits(params, batch)
            ref_toks = greedy(params)
        ref_loss, _, ref_g = steps.loss_and_grads(model, params, batch)
        runs = []
        for _ in range(2):
            with act.use(mesh):
                with torch.no_grad():
                    lg = model.logits(local, batch)
                    tk = greedy(local)
                loss, _, grads = steps.loss_and_grads(model, local, batch)
            runs.append((lg, tk, loss, grads))
        lg, tk, loss, grads = runs[0]
        whole = flatten(tp.gather_tree(grads, specs, mesh, cfg))
        top2 = torch.topk(ref_logits[..., :cfg.vocab_size], 2, -1).values
        out[arch] = dict(
            logits_err=float((lg - ref_logits).abs().max()),
            loss_err=abs(float(loss - ref_loss)),
            grad_err=max(float((whole[k].float() - v.float()).abs().max())
                         for k, v in flatten(ref_g).items()),
            tokens=tk.tolist(), ref_tokens=ref_toks.tolist(),
            min_margin=float((top2[..., 0] - top2[..., 1]).min()),
            bitwise=bool(torch.equal(lg, runs[1][0])
                         and torch.equal(tk, runs[1][1])
                         and torch.equal(loss, runs[1][2])))
    return out


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    return run_world(_tp_body, 2, tmp_path_factory.mktemp("tp"),
                     ARCHS + tuple(ODD))


@pytest.mark.parametrize("arch", ARCHS + tuple(ODD))
def test_tp_logits_and_loss_match_local(tp_world, arch):
    for rank in tp_world:
        r = rank[arch]
        assert r["logits_err"] <= 1e-5, r
        assert r["loss_err"] <= 1e-5, r
    assert tp_world[0][arch] == tp_world[1][arch]      # every rank alike


@pytest.mark.parametrize("arch", ARCHS + tuple(ODD))
def test_tp_gradients_match_local(tp_world, arch):
    for rank in tp_world:
        assert rank[arch]["grad_err"] <= 1e-5, rank[arch]


@pytest.mark.parametrize("arch", ARCHS + tuple(ODD))
def test_tp_greedy_tokens_and_determinism(tp_world, arch):
    for rank in tp_world:
        r = rank[arch]
        assert r["tokens"] == r["ref_tokens"], r["min_margin"]
        assert r["bitwise"]


# -------------------------------------------------------------- compression
def _grads(rank):
    rng = np.random.default_rng(100 + rank)
    return {"w": rng.standard_normal((64,)).astype(np.float32),
            "b": (rng.standard_normal((4, 8)) * 1e-3).astype(np.float32)}


def _compress_body(rank, world):
    from repro_torch.parallel import compression
    g = {k: torch.from_numpy(v) for k, v in _grads(rank).items()}
    r0 = compression.init_residuals(g)
    mean1, r1 = compression.compress_allreduce(g, r0)
    mean2, r2 = compression.compress_allreduce(g, r1)
    plain = compression.plain_allreduce(g)
    np_ = lambda t: {k: v.numpy() for k, v in t.items()}
    return dict(mean1=np_(mean1), r1=np_(r1), mean2=np_(mean2), r2=np_(r2),
                plain=np_(plain))


def test_compress_allreduce_matches_jax_quantize(tmp_path):
    import jax.numpy as jnp

    from repro.parallel import compression as jcomp
    out = run_world(_compress_body, 2, tmp_path)
    grads = [_grads(r) for r in range(2)]
    for k in grads[0]:
        deq, res = [], []
        for r in range(2):
            q, s = jcomp._quantize(jnp.asarray(grads[r][k]))
            d = np.asarray(q, np.float32) * np.float32(s)
            deq.append(d)
            res.append(grads[r][k] - d)
            np.testing.assert_allclose(out[r]["r1"][k], res[r], atol=1e-6,
                                       rtol=0)
        want = (deq[0] + deq[1]) / 2
        for r in range(2):
            np.testing.assert_allclose(out[r]["mean1"][k], want, atol=1e-6,
                                       rtol=0)
            np.testing.assert_array_equal(out[r]["mean1"][k],
                                          out[0]["mean1"][k])
            np.testing.assert_allclose(
                out[r]["plain"][k], (grads[0][k] + grads[1][k]) / 2,
                atol=1e-7, rtol=0)
        # error feedback: two rounds carry the first round's error back
        true = (grads[0][k] + grads[1][k]) / 2
        scale = max(np.abs(g[k]).max() for g in grads) / 127.0
        err1 = np.abs(out[0]["mean1"][k] - true).max()
        assert err1 <= scale * 0.51 + 1e-6
        total = out[0]["mean1"][k] + out[0]["mean2"][k]
        np.testing.assert_allclose(total, 2 * true, atol=2 * scale)


# ----------------------------------------------------- a (2, 2) serve trace
def _serve_22(rank, world, w):
    from test_torch_mesh_serve import _Serve, _mesh
    mesh = _mesh(rank, world, (2, 2))
    s = _Serve(w)
    # DensePolicy: no scoring forward on each of the four ranks
    return [s.run(mesh, policy="dense")[0], s.run(mesh, policy="dense")[0]]


def test_two_by_two_serves_deterministically(tmp_path):
    """``ShardedExecutor`` on a (2, 2) mesh (DP slots and TP blocks at
    once, ``test_torch_mesh_serve.py``'s engine trace): served to the end,
    twice, bitwise, every rank alike."""
    from test_torch_mesh_serve import L, _weights
    out = run_world(_serve_22, 4, tmp_path, _weights("llama2-7b", L))
    for a, b in out:
        assert {v[0] for v in a.values()} == {"done"} and a == b
    assert all(o == out[0] for o in out)
