"""The port's controller training against the JAX package's, on the CPU.

Seeded numpy inputs and JAX-initialised weights (carried by
``repro_torch.bridge``) go through both packages:

* AdamW ``apply`` for 3 steps, with clipping active and inactive, under the
  constant, cosine and linear schedules (params, moments and metrics within
  1e-6);
* one ``td_update`` and one ``soft_update`` from the same Q-net, target net
  and batch (loss and params within 1e-6); ``Replay.sample`` and
  ``select_action`` draw the same indices and actions from one numpy seed;
* ``PruneEnv`` on SMOKE llama2 (4 layers) and mamba2 under a fixed action
  sequence: observations and rewards within 1e-5, masks, ``fits`` and
  ``valid_actions`` equal;
* ``train`` end to end with the JAX suite's settings (4 episodes,
  ``eps_decay_episodes=2``, ``batch_size=16``; JAX's initial Q-net carried
  into the port): rewards within 1e-5, fits equal, losses and final params
  within 1e-4;
* ``launch.serve --episodes 2`` on the CPU trains, then serves.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import dqn as jdqn, env as jenv, memory as jmem
from repro.data import SyntheticCorpus as JaxCorpus
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import dqn, env, memory
from repro_torch.models import registry
from repro_torch.optim import adamw

torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what=""):
    got = {k: v.detach().numpy() for k, v in got.items()}
    for k, w in _np(want).items():
        np.testing.assert_allclose(got[k], w, atol=tol, rtol=tol,
                                   err_msg=f"{what}{k}")


def _qnet(seed, state_dim, n_actions, hidden):
    return jdqn.init_qnet(jax.random.key(seed), state_dim, n_actions, hidden)


# -------------------------------------------------------------- AdamW
@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear"])
@pytest.mark.parametrize("clip", [0.5, 0.0], ids=["clipped", "unclipped"])
def test_adamw_matches_jax(schedule, clip):
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((6, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    cfg_kw = dict(lr=3e-2, weight_decay=0.1, clip_norm=clip,
                  warmup_steps=2, total_steps=5, schedule=schedule)
    jp = jax.tree.map(jnp.asarray, params)
    tp = bridge.params_from_numpy(params, "cpu")
    js, ts = jadamw.init(jp), adamw.init(tp)
    for step in range(3):
        grads = {"a": 3.0 * rng.standard_normal((6, 5)).astype(np.float32),
                 "b": {"c": rng.standard_normal(7).astype(np.float32)}}
        jp, js, jm = jadamw.apply(jadamw.AdamWConfig(**cfg_kw), jp,
                                  jax.tree.map(jnp.asarray, grads), js)
        tp, ts, tm = adamw.apply(adamw.AdamWConfig(**cfg_kw), tp,
                                 bridge.params_from_numpy(grads, "cpu"), ts)
        if clip:
            assert float(jm["grad_norm"]) > clip     # the clip is active
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6, atol=1e-9)
    assert int(ts.step) == int(js.step) == 3
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got["b"]["c"].numpy(),
                                   np.asarray(want["b"]["c"]),
                                   atol=1e-6, rtol=1e-6)


# ------------------------------------------------------ TD and replay
def _batch(rng, n, state_dim, n_actions):
    valid2 = rng.random((n, n_actions)) < 0.6
    valid2[:, 0] = True
    return (rng.standard_normal((n, state_dim)).astype(np.float32),
            rng.integers(0, n_actions, n).astype(np.int32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal((n, state_dim)).astype(np.float32),
            (rng.random(n) < 0.3).astype(np.float32), valid2)


def test_td_and_soft_update_match_jax():
    rng = np.random.default_rng(5)
    jq, jt = _qnet(0, 12, 9, 16), _qnet(1, 12, 9, 16)
    batch = _batch(rng, 16, 12, 9)
    jq2, jopt, jloss = jdqn.td_update(jq, jt, jadamw.init(jq),
                                      tuple(jnp.asarray(x) for x in batch),
                                      0.99, 1e-3)
    tq, tt = bridge.qnet_from_numpy(_np(jq)), bridge.qnet_from_numpy(_np(jt))
    tq2, topt, tloss = dqn.td_update(tq, tt, adamw.init(tq),
                                     tuple(torch.from_numpy(x) for x in batch),
                                     0.99, 1e-3)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    _close(tq2, jq2, 1e-6, "td ")
    _close(topt.mu, jopt.mu, 1e-6, "mu ")
    _close(dqn.soft_update(tt, tq2, 0.01), jdqn.soft_update(jt, jq2, 0.01),
           1e-6, "soft ")


def test_replay_and_select_action_draw_alike():
    rng = np.random.default_rng(7)
    bufs = (jdqn.Replay(40, 6, 5), dqn.Replay(40, 6, 5))
    for _ in range(50):                     # wraps the ring
        item = (rng.standard_normal(6), int(rng.integers(0, 5)),
                float(rng.standard_normal()), rng.standard_normal(6),
                float(rng.random() < 0.2), rng.random(5) < 0.5)
        for b in bufs:
            b.add(*item)
    assert len(bufs[0]) == len(bufs[1]) == 40
    for x, y in zip(bufs[0].sample(np.random.default_rng(1), 16),
                    bufs[1].sample(np.random.default_rng(1), 16)):
        np.testing.assert_array_equal(x, y)
    jq = _qnet(2, 6, 5, 8)
    tq = bridge.qnet_from_numpy(_np(jq))
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for i in range(40):
        s = rng.standard_normal(6).astype(np.float32)
        valid = rng.random(5) < 0.6
        valid[i % 5] = True
        eps = (0.0, 0.5, 1.0)[i % 3]
        assert (jdqn.select_action(jq, s, valid, eps, r1)
                == dqn.select_action(tq, s, valid, eps, r2))
    assert dqn.n_params(tq) == jdqn.n_params(jq)


# -------------------------------------------------------------- PruneEnv
@functools.lru_cache(maxsize=None)
def _env_pair(arch):
    """(jax env, port env) on bridged SMOKE weights and one calib batch."""
    kw = {"n_layers": 4} if arch == "llama2-7b" else {}
    jm = jreg.build(jax_smoke(arch).replace(**kw))
    jp = jm.init(jax.random.key(0))
    calib = JaxCorpus(jm.cfg.vocab_size, seed=7).batch(2, 32, split="calib")
    tm = registry.build(get_smoke_config(arch).replace(**kw))
    tp = bridge.params_from_numpy(_np(jp), "cpu")
    je = jenv.PruneEnv(jm, jp, {k: jnp.asarray(v) for k, v in calib.items()},
                       jmem.build_memory_model(jm.cfg))
    te = env.PruneEnv(tm, tp, {k: torch.from_numpy(v)
                               for k, v in calib.items()},
                      memory.build_memory_model(tm.cfg))
    return je, te


@pytest.mark.parametrize("arch", ["llama2-7b", "mamba2-370m"])
def test_prune_env_matches_jax(arch):
    je, te = _env_pair(arch)
    assert (te.state_dim, te.n_actions) == (je.state_dim, je.n_actions)
    budget = 0.6 * je.mm.dense_peak(4, 256)
    obs = (je.reset(4, 256, budget), te.reset(4, 256, budget))
    # remove the middle remaining block three times, then STOP if legal
    for k in range(4):
        np.testing.assert_allclose(obs[1], obs[0], atol=1e-5, rtol=1e-5)
        valid = je.valid_actions()
        np.testing.assert_array_equal(te.valid_actions(), valid)
        assert te.fits() == je.fits()
        blocks = np.nonzero(valid[1:])[0] + 1
        a = 0 if k == 3 and valid[0] else int(blocks[len(blocks) // 2])
        jo, jr, jd, ji = je.step(a)
        to, tr, td, ti = te.step(a)
        obs = (jo, to)
        np.testing.assert_allclose(tr, jr, atol=1e-5)
        assert td == jd and ti["fits"] == ji["fits"]
        np.testing.assert_array_equal(ti["mask"], ji["mask"])
        np.testing.assert_allclose(ti["log_ppl"], ji["log_ppl"], atol=1e-5)
        if jd:
            break
    np.testing.assert_allclose(obs[1], obs[0], atol=1e-5, rtol=1e-5)
    assert te.forwards > 0


def test_train_matches_jax(monkeypatch):
    je, te = _env_pair("llama2-7b")
    mm = je.mm

    def sampler(rng):
        bs = int(rng.integers(1, 8))
        sql = int(rng.integers(64, 512))
        return bs, sql, 0.45 * mm.dense_peak(bs, sql)

    jtr = jdqn.train(lambda: je, episodes=4,
                     cfg=jdqn.DQNConfig(eps_decay_episodes=2, batch_size=16),
                     request_sampler=sampler, seed=0)
    # JAX's initial Q-net, carried across: the draws of the two frameworks'
    # generators cannot be equal
    q0 = bridge.qnet_from_numpy(_np(_qnet(0, te.state_dim, te.n_actions, 64)))
    monkeypatch.setattr(dqn, "init_qnet", lambda *a: {k: v.clone()
                                                      for k, v in q0.items()})
    ttr = dqn.train(lambda: te, episodes=4,
                    cfg=dqn.DQNConfig(eps_decay_episodes=2, batch_size=16),
                    request_sampler=sampler, seed=0)
    np.testing.assert_allclose(ttr.episode_rewards, jtr.episode_rewards,
                               atol=1e-5)
    assert ttr.episode_fits == jtr.episode_fits and all(ttr.episode_fits)
    assert len(ttr.losses) == len(jtr.losses) >= 1
    np.testing.assert_allclose(ttr.losses, jtr.losses, rtol=1e-4, atol=1e-4)
    _close(ttr.q_params, jtr.q_params, 1e-4, "trained ")


def test_serve_trains_then_serves_on_cpu(capsys):
    from repro_torch.launch import serve
    eng, rep = serve.main(["--smoke", "--device", "cpu", "--episodes", "2",
                           "--requests", "3", "--max-prompt", "32",
                           "--max-new", "4", "--mode", "masked"])
    out = capsys.readouterr().out
    assert "training RAP controller (2 episodes)" in out
    assert "reward: first=" in out and "s/episode" in out
    assert all(r.status == "done" for r in rep.results)
    assert rep.generated_tokens == sum(r.tokens.size for r in rep.results)
