"""The port imports and runs — the stencil plan, stage programs (a chain,
and DAGs on the reference and hopper backends), a custom stencil traced
for the kernel, the LM serving path (qwen3 and granite's untied head), two
training steps, a batched ``run_batch`` and a ``StencilService`` serving a
few requests and a checkpointed one — with JAX and the reference package
made unimportable."""
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

SCRIPT = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch
torch.set_num_threads(1)
import repro_torch.api as api
import repro_torch.convert, repro_torch.kernels._build
p = api.plan(api.StencilProblem("hotspot2d", (9, 30)),
             api.RunConfig(backend="hopper", par_time=2, bsize=12,
                           device="cpu"))
rng = np.random.default_rng(0)
out = p.run(rng.uniform(0.5, 2, (9, 30)).astype(np.float32), 5,
            aux=rng.uniform(0, 0.1, (9, 30)).astype(np.float32))
assert out.shape == (9, 30) and bool(out.isfinite().all())
from repro_torch.core.stencils import make_star
prog = [api.StencilStage(make_star(2, 1), coeffs={"c0": 0.7}),
        api.StencilStage("diffusion2d")]
chain = api.plan(api.StencilProblem(prog, (9, 30)),
                 api.RunConfig(backend="hopper", par_time=2, bsize=12,
                               device="cpu"))
g = rng.uniform(0.5, 2, (9, 30)).astype(np.float32)
ref = api.plan(api.StencilProblem(prog, (9, 30)),
               api.RunConfig(backend="reference", device="cpu"))
assert torch.equal(chain.run(g, 5), ref.run(g, 5))
dag = api.StencilProgram(
    (api.StencilStage(make_star(2, 1), name="a", inputs=("u",)),),
    fields=("u", "v"), updates={"u": "a", "v": "u"})
state = api.plan(
    api.StencilProblem(dag, (9, 30)),
    api.RunConfig(backend="reference", device="cpu")).run(
        rng.uniform(0.5, 2, (2, 9, 30)).astype(np.float32), 3)
assert state.shape == (2, 9, 30)
from repro_torch.core.stencils import make_combine
wave = api.StencilProgram(
    (api.StencilStage(make_star(2, 1), name="lapu", inputs=("u",)),
     api.StencilStage(make_combine(2, 3), name="unext",
                      inputs=("u", "u_prev", "lapu"),
                      coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.1})),
    fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})
s0 = rng.uniform(0.5, 2, (2, 9, 30)).astype(np.float32)
runs = [api.plan(api.StencilProblem(wave, (9, 30), boundary="periodic"),
                 api.RunConfig(backend=b, device="cpu", **kw)).run(s0, 3)
        for b, kw in (("hopper", dict(par_time=2, bsize=12)),
                      ("reference", {}))]
assert runs[0].shape == (2, 9, 30) and torch.equal(*runs)
from repro_torch.core.stencils import Stencil
cubic = Stencil("cubic2d", 2, 1, 6, 1, 1, False, ("k",),
                lambda get, c, aux=None: get((0, 0)) + c["k"] * (
                    get((0, 1)) - get((0, 0)) ** 3))
custom = [api.plan(api.StencilProblem(api.StencilStage(cubic,
                                                       coeffs={"k": 0.1}),
                                      (9, 30)),
                   api.RunConfig(backend=b, device="cpu", **kw)).run(g, 3)
          for b, kw in (("hopper", dict(par_time=2, bsize=12)),
                        ("reference", {}))]
assert torch.equal(*custom)
import repro_torch.models, repro_torch.launch.serve as serve
from repro_torch.configs import smoke_config
cfg = smoke_config("qwen3-1.7b")
params = repro_torch.models.init_params(
    cfg, torch.Generator().manual_seed(0), "cpu")
gen = serve.generate(cfg, params,
                     torch.from_numpy(rng.integers(1, cfg.vocab, (2, 16))),
                     3)
assert gen.tokens.shape == (2, 3) and bool(gen.logits.isfinite().all())
assert bool(((gen.tokens >= 0) & (gen.tokens < cfg.vocab)).all())
gcfg = smoke_config("granite-3-8b")
gparams = repro_torch.models.init_params(
    gcfg, torch.Generator().manual_seed(0), "cpu")
assert "head" in gparams["embed"]
ggen = serve.generate(gcfg, gparams,
                      torch.from_numpy(rng.integers(1, gcfg.vocab, (2, 16))),
                      3)
assert ggen.tokens.shape == (2, 3) and bool(ggen.logits.isfinite().all())
import repro_torch.checkpoint, repro_torch.data, repro_torch.optim
import repro_torch.resilience, repro_torch.train
import repro_torch.launch.train as launch_train
from repro_torch.convert import opt_state_from_reference
from repro_torch.configs import SHAPES
events = launch_train.main(["--arch", "qwen3-1.7b", "--smoke", "--device",
                            "cpu", "--steps", "2", "--batch", "2", "--seq",
                            "16"])
assert len(events["losses"]) == 2 and all(np.isfinite(events["losses"]))
import asyncio, tempfile
import repro_torch.resilience, repro_torch.serve as rserve
sp = api.plan(api.StencilProblem("diffusion2d", (12, 32)),
              api.RunConfig(backend="hopper", par_time=2, bsize=16,
                            device="cpu"))
grids = rng.uniform(0.5, 2, (3, 12, 32)).astype(np.float32)
batch = sp.run_batch(grids, 5)
assert all(torch.equal(batch[b], sp.run(grids[b], 5)) for b in range(3))


async def serve_a_few(ckdir):
    svc = await rserve.from_config({
        "buckets": [{"problem": {"stencil": "diffusion2d",
                                 "shape": [12, 32]},
                     "run": {"backend": "hopper", "par_time": 2,
                             "bsize": 16, "device": "cpu"},
                     "max_batch": 4, "max_wait_ms": 5.0}],
        "checkpoint_dir": ckdir})
    futs = [svc.submit_nowait(rserve.StencilRequest("diffusion2d", g, 3))
            for g in grids]
    futs.append(svc.submit_nowait(rserve.StencilRequest(
        "diffusion2d", grids[0], 6, checkpoint_key="job",
        checkpoint_every=2)))
    out = await asyncio.gather(*futs)
    snap = svc.snapshot()
    await svc.stop()
    return out, snap


with tempfile.TemporaryDirectory() as ckdir:
    served, snap = asyncio.run(serve_a_few(ckdir))
assert all(torch.equal(r.grid, sp.run(g, 3)) for r, g in zip(served, grids))
assert torch.equal(served[-1].grid, sp.run(grids[0], 6))
assert snap["completed"] == 4 and snap["failed_total"] == 0
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("isolated-ok")
"""


def test_port_runs_without_jax_or_reference_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "isolated-ok" in proc.stdout
