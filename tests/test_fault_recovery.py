"""Fault injection / checkpoint-restart recovery (SURVEY.md §5.3).

The survey's recovery model: MCMC is trivially restartable — periodic
block checkpoints + restart on a replacement process.  This test implements
the §5.3 fault-injection hook: a worker process samples in blocks with
checkpointing, gets SIGKILLed mid-run (a dead host, not a clean exception),
and a replacement process resumes from the last completed block.  The
recovered run's remaining draws must be bitwise-identical to the same
blocks of an uninterrupted run (per-chain PRNG keys live in the checkpoint,
so continuation is deterministic on a fixed backend).
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

_WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import starcat
from starcat.driver import init_chain_states, sample_blocked, warmup
from starcat.hmc import HMCConfig, make_hmc_kernel

mode = sys.argv[1]            # "full" | "crash" | "resume"
ckpt = sys.argv[2]
out = sys.argv[3]

spec = starcat.SceneSpec(12, 12, 1.5, 4.0)
prior = starcat.PriorSpec(3.0, 0.7)
truth = starcat.sample_prior(jax.random.key(0), 2, prior)
x, y, f = starcat.constrain(truth, spec)
img = starcat.make_mock_image(jax.random.key(1), x, y, f, spec)
mask = jnp.ones(2)
pg = starcat.make_potential_and_grad(spec, img, prior)
grad_fn = lambda th: pg(th, mask)
theta0 = truth[None] + 0.01 * jax.random.normal(jax.random.key(2), (4, 2, 3))

kernel = make_hmc_kernel(grad_fn, mask, HMCConfig(step_size=0.05, n_leapfrog=5))
states = init_chain_states(jax.random.key(3), theta0, grad_fn)
eps = jnp.asarray(0.05)
inv_mass = jnp.ones((2, 3))

N, BLOCK = 40, 10

if mode == "crash":
    # save checkpoints per block, then die hard after 2 blocks (no cleanup,
    # no atexit — simulates a host failure)
    from starcat.driver import BlockCheckpoint
    from starcat.checkpoint import save_state
    done = 0
    while True:
        res = sample_blocked(states, kernel, done + BLOCK, eps, inv_mass,
                             block_size=BLOCK, checkpoint_path=ckpt,
                             start_done=done)
        states = res.final_states
        done += BLOCK
        if done >= 2 * BLOCK:
            os.kill(os.getpid(), 9)   # SIGKILL mid-run
elif mode == "resume":
    from starcat.checkpoint import restore_state
    from starcat.driver import checkpoint_like
    ck = restore_state(ckpt, checkpoint_like(states))
    assert int(ck.done) == 2 * BLOCK, f"expected resume at 20, got {int(ck.done)}"
    res = sample_blocked(ck.states, kernel, N, ck.step_size, ck.inv_mass,
                         block_size=BLOCK, checkpoint_path=ckpt,
                         start_done=int(ck.done))
    np.save(out, np.asarray(res.thetas))
else:  # full, uninterrupted
    res = sample_blocked(states, kernel, N, eps, inv_mass, block_size=BLOCK)
    np.save(out, np.asarray(res.thetas))
print("WORKER_DONE", mode)
"""


def _run_worker(tmp_path, mode: str, ckpt: str, out: str):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(_WORKER)
    return subprocess.run(
        [sys.executable, str(worker_py), mode, ckpt, out],
        capture_output=True, text=True, timeout=560, env=env,
    )


@pytest.mark.slow
def test_sigkill_midrun_then_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    full_out = str(tmp_path / "full.npy")
    resume_out = str(tmp_path / "resume.npy")

    # 1. uninterrupted golden run
    r = _run_worker(tmp_path, "full", str(tmp_path / "unused"), full_out)
    assert r.returncode == 0, r.stderr

    # 2. worker killed by SIGKILL after 2 of 4 blocks
    r = _run_worker(tmp_path, "crash", ckpt, str(tmp_path / "no.npy"))
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr)
    assert os.path.exists(ckpt), "no checkpoint left behind by crashed worker"

    # 3. replacement process restores and completes the remaining blocks
    r = _run_worker(tmp_path, "resume", ckpt, resume_out)
    assert r.returncode == 0, r.stderr
    assert "WORKER_DONE resume" in r.stdout

    full = np.load(full_out)        # (C, 40, K, 3)
    resumed = np.load(resume_out)   # (C, 20, K, 3) — blocks 3-4 only
    assert resumed.shape[1] == 20
    np.testing.assert_array_equal(resumed, full[:, 20:])


def test_run_mcmc_resume_api(tmp_path):
    """run_mcmc(resume=True) skips warmup and continues from the block
    checkpoint — same draws as the uninterrupted blocked run."""
    import jax
    import jax.numpy as jnp
    import starcat
    from starcat.driver import init_chain_states, run_mcmc
    from starcat.hmc import HMCConfig, make_hmc_kernel

    spec = starcat.SceneSpec(10, 10, 1.5, 4.0)
    prior = starcat.PriorSpec(3.0, 0.7)
    truth = starcat.sample_prior(jax.random.key(0), 2, prior)
    x, y, f = starcat.constrain(truth, spec)
    img = starcat.make_mock_image(jax.random.key(1), x, y, f, spec)
    mask = jnp.ones(2)
    pg = starcat.make_potential_and_grad(spec, img, prior)
    grad_fn = lambda th: pg(th, mask)
    theta0 = truth[None] + 0.01 * jax.random.normal(jax.random.key(2), (4, 2, 3))
    kernel = make_hmc_kernel(grad_fn, mask, HMCConfig(step_size=0.05, n_leapfrog=5))

    ckpt = str(tmp_path / "ck")
    res1, wr1 = run_mcmc(jax.random.key(3), kernel, grad_fn, theta0,
                         n_samples=20, n_warmup=10, block_size=10,
                         checkpoint_path=ckpt)
    # "crash" after the full run; a resume run should produce ZERO new draws
    res2, wr2 = run_mcmc(jax.random.key(3), kernel, grad_fn, theta0,
                         n_samples=20, n_warmup=10, block_size=10,
                         checkpoint_path=ckpt, resume=True)
    assert res2.thetas.shape[1] == 0
    assert float(wr2.step_size) == pytest.approx(float(wr1.step_size))
    np.testing.assert_array_equal(
        np.asarray(res2.final_states.theta), np.asarray(res1.final_states.theta)
    )


_SMC_WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import starcat
from starcat.smc import SMCConfig, run_smc

mode = sys.argv[1]            # "full" | "crash" | "resume"
ckpt = sys.argv[2]
out = sys.argv[3]

spec = starcat.SceneSpec(12, 12, 1.5, 4.0)
prior = starcat.PriorSpec(3.5, 0.6)
img = starcat.make_mock_image(
    jax.random.key(1), jnp.array([4.0, 8.0]), jnp.array([6.0, 6.0]),
    jnp.array([70.0, 50.0]), spec)
cfg = SMCConfig(n_particles=64, mutation="hmc", n_mutation_steps=2,
                n_leapfrog=4, max_steps=40)
key = jax.random.key(3)

class Killer:
    "Logger that SIGKILLs the process after 3 temperature steps (crash mode)."
    def __init__(self, n): self.n, self.seen = n, 0
    def log(self, event, **kw):
        if event == "smc_temperature_step":
            self.seen += 1
            if self.seen >= self.n:
                os.kill(os.getpid(), 9)

if mode == "crash":
    run_smc(key, spec, img, prior, 4, cfg, checkpoint_path=ckpt,
            logger=Killer(3))
    raise SystemExit("should have been SIGKILLed")
elif mode == "resume":
    res = run_smc(key, spec, img, prior, 4, cfg, checkpoint_path=ckpt,
                  resume=True)
else:
    class Null:
        def log(self, *a, **k): pass
    res = run_smc(key, spec, img, prior, 4, cfg, logger=Null())
np.savez(out, theta=np.asarray(res.theta), log_z=float(res.log_z),
         n_steps=int(res.n_steps))
print("WORKER_DONE", mode)
"""


@pytest.mark.slow
def test_smc_sigkill_mid_tempering_then_resume(tmp_path):
    """SIGKILL the SMC worker mid-tempering (after 3 temperature steps);
    a replacement process resumes from the per-step checkpoint and
    finishes with the SAME logZ and particles as an uninterrupted run
    (VERDICT round-1 item 5 'done' criterion)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    worker_py = tmp_path / "smc_worker.py"
    worker_py.write_text(_SMC_WORKER)
    ckpt = str(tmp_path / "smc_ckpt")
    full_out = str(tmp_path / "full.npz")
    resume_out = str(tmp_path / "resume.npz")

    def run(mode, out):
        return subprocess.run(
            [sys.executable, str(worker_py), mode, ckpt, out],
            capture_output=True, text=True, timeout=560, env=env,
        )

    r = run("full", full_out)
    assert r.returncode == 0, r.stderr

    r = run("crash", str(tmp_path / "no.npz"))
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr)
    assert os.path.exists(ckpt), "no checkpoint left by crashed SMC worker"

    r = run("resume", resume_out)
    assert r.returncode == 0, r.stderr

    full = np.load(full_out)
    resumed = np.load(resume_out)
    assert int(resumed["n_steps"]) == int(full["n_steps"])
    np.testing.assert_allclose(float(resumed["log_z"]), float(full["log_z"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(resumed["theta"], full["theta"])


_CHEES_WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from starcat.chees import (ChEESConfig, chees_checkpoint_like,
                           chees_sample_blocked, run_chees)
from starcat.driver import init_chain_states

mode = sys.argv[1]            # "full" | "crash" | "resume"
ckpt = sys.argv[2]
out = sys.argv[3]

sigma = jnp.array([[0.5, 1.0, 2.0]])
def gf(theta):
    z = theta / sigma
    return 0.5 * jnp.sum(z * z), z / sigma

theta0 = 0.5 * jax.random.normal(jax.random.key(0), (8, 1, 3))
mask = jnp.ones(1)
# max_warmup_extensions=0 / max_eq_stages=0: the crash-mode worker
# replicates ONLY the base warmup leg below, so the full/resume paths
# must run neither T-extensions nor the round-5 equilibration blocks
# (gate-on resume consistency is covered by run_chees-level tests in
# test_chees.py; this test pins the SIGKILL + checkpoint-file flow)
cfg = ChEESConfig(step_size=0.3, traj_length=0.5, max_warmup_extensions=0,
                  max_eq_stages=0)
N, WARM, BLOCK = 40, 30, 10

if mode == "crash":
    # run warmup + 2 blocks with checkpoints, then die hard (no cleanup)
    from starcat.checkpoint import restore_state, save_state
    states0 = init_chain_states(jax.random.key(1), theta0, gf)
    # replicate run_chees's warmup leg, then sample 2 blocks and SIGKILL
    from starcat.chees import _chees_warmup_jit
    wu = _chees_warmup_jit(states0, gf, mask, WARM, cfg)
    st, eps, inv_mass, traj = wu.states, wu.step_size, wu.inv_mass, wu.traj
    chees_sample_blocked(st, gf, mask, 2 * BLOCK, eps, inv_mass, traj, cfg,
                         n_warmup=WARM, block_size=BLOCK,
                         checkpoint_path=ckpt)
    os.kill(os.getpid(), 9)   # SIGKILL mid-run
elif mode == "resume":
    res, ad = run_chees(jax.random.key(1), gf, theta0, mask, N, WARM, cfg,
                        block_size=BLOCK, checkpoint_path=ckpt, resume=True)
    assert res.thetas.shape[1] == N - 2 * BLOCK, res.thetas.shape
    np.save(out, np.asarray(res.thetas))
else:  # full, uninterrupted
    res, ad = run_chees(jax.random.key(1), gf, theta0, mask, N, WARM, cfg,
                        block_size=BLOCK)
    np.save(out, np.asarray(res.thetas))
print("WORKER_DONE", mode)
"""


@pytest.mark.slow
def test_chees_sigkill_midrun_then_resume(tmp_path):
    """SIGKILL a ChEES worker after 2 of 4 sampling blocks; a replacement
    process resumes from the ChEESBlockCheckpoint and its remaining draws
    are bitwise-identical to the uninterrupted run (VERDICT round-2
    Missing #2 'done' criterion)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    worker_py = tmp_path / "chees_worker.py"
    worker_py.write_text(_CHEES_WORKER)
    ckpt = str(tmp_path / "chees_ckpt")
    full_out = str(tmp_path / "full.npy")
    resume_out = str(tmp_path / "resume.npy")

    def run(mode, out):
        return subprocess.run(
            [sys.executable, str(worker_py), mode, ckpt, out],
            capture_output=True, text=True, timeout=560, env=env,
        )

    r = run("full", full_out)
    assert r.returncode == 0, r.stderr

    r = run("crash", str(tmp_path / "no.npy"))
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr)
    assert os.path.exists(ckpt), "no checkpoint left by crashed ChEES worker"

    r = run("resume", resume_out)
    assert r.returncode == 0, r.stderr

    full = np.load(full_out)        # (C, 40, 1, 3)
    resumed = np.load(resume_out)   # (C, 20, 1, 3) — blocks 3-4 only
    np.testing.assert_array_equal(resumed, full[:, 20:])


@pytest.mark.slow
def test_smc_resume_skips_completed_final_rounds(tmp_path):
    """The beta=1 checkpoint records completed posterior ("final") rounds
    (SMCState.final_done): a resume runs only the REMAINING n_final_rounds
    instead of repeating all of them (VERDICT round-2 Missing #5 — the
    cfg4 extended-posterior studies are resume loops over exactly this)."""
    import jax
    import jax.numpy as jnp

    import starcat
    from starcat.smc import SMCConfig, run_smc

    spec = starcat.SceneSpec(12, 12, 1.5, 4.0)
    prior = starcat.PriorSpec(3.5, 0.6)
    img = starcat.make_mock_image(
        jax.random.key(1), jnp.array([4.0, 8.0]), jnp.array([6.0, 6.0]),
        jnp.array([70.0, 50.0]), spec)
    cfg = SMCConfig(n_particles=64, mutation="hmc", n_mutation_steps=2,
                    n_leapfrog=4, max_steps=40, n_final_rounds=3)
    ckpt = str(tmp_path / "smc_final_ckpt")

    class Counter:
        def __init__(self):
            self.steps = 0

        def log(self, event, **kw):
            if event == "smc_temperature_step":
                self.steps += 1

    c1 = Counter()
    res1 = run_smc(jax.random.key(3), spec, img, prior, 4, cfg,
                   checkpoint_path=ckpt, logger=c1)
    assert float(res1.beta) == 1.0

    # same budget -> nothing left to do: 0 extra temperature steps
    c2 = Counter()
    res2 = run_smc(jax.random.key(3), spec, img, prior, 4, cfg,
                   checkpoint_path=ckpt, resume=True, logger=c2)
    assert c2.steps == 0
    np.testing.assert_array_equal(np.asarray(res2.theta),
                                  np.asarray(res1.theta))

    # raised budget -> exactly the difference is run
    c3 = Counter()
    run_smc(jax.random.key(3), spec, img, prior, 4,
            cfg._replace(n_final_rounds=5), checkpoint_path=ckpt,
            resume=True, logger=c3)
    assert c3.steps == 2


def test_sharded_checkpoint_roundtrip_and_resume(tmp_path):
    """SURVEY.md §5.4 "multi-host-aware save of sharded arrays" (VERDICT
    round-3 item 6): an SMCState whose particle arrays carry a NamedSharding
    over the fake 8-device mesh is saved with save_state, restored into a
    SHARDED template (leaves keep their sharding), and resumed — and the
    resumed trajectory matches a resume of the same checkpoint restored
    unsharded (the sharded program is the same program, SURVEY.md §5.8)."""
    import jax
    import jax.numpy as jnp

    import starcat
    from starcat.checkpoint import restore_state, save_state
    from starcat.dist import make_mesh, shard_chains
    from starcat.smc import SMCConfig, _smc_step_jit, init_smc
    from starcat.transdim import TransDimConfig

    spec = starcat.SceneSpec(12, 12, 1.5, 3.0)
    prior = starcat.PriorSpec(3.0, 0.7)
    truth = starcat.sample_prior(jax.random.key(0), 3, prior)
    x, y, f = starcat.constrain(truth, spec)
    img = starcat.make_mock_image(jax.random.key(1), x, y, f, spec)
    cfg = SMCConfig(n_particles=64, mutation="hmc", n_leapfrog=3,
                    n_mutation_steps=1, n_transdim_sweeps=1, max_steps=4,
                    transdim=TransDimConfig(lam_count=2.0))

    mesh = make_mesh("chains")
    assert mesh.devices.size == 8  # conftest forces the fake 8-device mesh

    def _shard(s):
        # whole-state sharding: particle arrays split, scalars replicated
        return shard_chains(s, mesh)

    s = _shard(init_smc(jax.random.key(2), spec, img, prior, 5, cfg))
    for _ in range(2):
        s = _smc_step_jit(s, spec, img, prior, cfg)

    ckpt = str(tmp_path / "smc_sharded")
    save_state(ckpt, s)

    # restore into a sharded template: every leaf keeps its NamedSharding
    like = _shard(init_smc(jax.random.key(9), spec, img, prior, 5, cfg))
    s_back = restore_state(ckpt, like)
    assert len(s_back.theta.sharding.device_set) == 8, s_back.theta.sharding
    np.testing.assert_array_equal(np.asarray(s_back.theta), np.asarray(s.theta))
    np.testing.assert_array_equal(np.asarray(s_back.mask), np.asarray(s.mask))
    assert float(s_back.beta) == float(s.beta)

    # resume sharded vs resume unsharded: same checkpoint, same program
    s_sh = _smc_step_jit(s_back, spec, img, prior, cfg)
    like_un = init_smc(jax.random.key(9), spec, img, prior, 5, cfg)
    s_un = _smc_step_jit(restore_state(ckpt, like_un), spec, img, prior, cfg)
    np.testing.assert_allclose(np.asarray(s_sh.theta), np.asarray(s_un.theta),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(s_sh.mask), np.asarray(s_un.mask))
    assert np.isclose(float(s_sh.log_z), float(s_un.log_z), atol=1e-4)


def test_corrupt_checkpoint_raises_chained_error(tmp_path):
    """A checkpoint that matches NEITHER the current nor the legacy layout
    must raise an error that names the path and both attempted layouts,
    with the ORIGINAL failure chained — not the confusing legacy-template
    failure alone (VERDICT round-4 item 8 / ADVICE round-4)."""
    import jax
    import jax.numpy as jnp

    import starcat
    from starcat.checkpoint import save_state
    from starcat.chees import ChEESConfig, run_chees
    from starcat.smc import SMCConfig, run_smc

    # an incompatible pytree saved at both paths
    junk = {"junk": jnp.zeros((3, 2)), "more": jnp.ones(())}

    ck_chees = str(tmp_path / "chees_bad")
    save_state(ck_chees, junk)

    def gf(theta):
        return 0.5 * jnp.sum(theta * theta), theta

    theta0 = 0.1 * jax.random.normal(jax.random.key(0), (8, 1, 3))
    with pytest.raises(RuntimeError) as ei:
        run_chees(jax.random.key(1), gf, theta0, jnp.ones(1), 4, 4,
                  ChEESConfig(step_size=0.2), checkpoint_path=ck_chees,
                  resume=True)
    msg = str(ei.value)
    assert "chees_bad" in msg and "legacy" in msg
    assert ei.value.__cause__ is not None  # original failure chained

    ck_smc = str(tmp_path / "smc_bad")
    save_state(ck_smc, junk)
    spec = starcat.SceneSpec(12, 12, 1.5, 3.0)
    prior = starcat.PriorSpec(3.0, 0.7)
    truth = starcat.sample_prior(jax.random.key(0), 2, prior)
    x, y, f = starcat.constrain(truth, spec)
    img = starcat.make_mock_image(jax.random.key(1), x, y, f, spec)
    cfg = SMCConfig(n_particles=32, mutation="hmc", n_leapfrog=3,
                    n_mutation_steps=1, max_steps=2)
    with pytest.raises(RuntimeError) as ei2:
        run_smc(jax.random.key(2), spec, img, prior, 2, cfg,
                checkpoint_path=ck_smc, resume=True)
    msg2 = str(ei2.value)
    assert "smc_bad" in msg2 and "legacy" in msg2
    assert ei2.value.__cause__ is not None
