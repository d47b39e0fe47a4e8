"""The port imports and runs — the stencil plan, the LM serving path and two
training steps — with JAX and the reference package made unimportable."""
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
import repro_torch.checkpoint, repro_torch.data, repro_torch.optim
import repro_torch.resilience, repro_torch.train
import repro_torch.launch.train as launch_train
from repro_torch.convert import opt_state_from_reference
from repro_torch.configs import SHAPES
events = launch_train.main(["--arch", "qwen3-1.7b", "--smoke", "--device",
                            "cpu", "--steps", "2", "--batch", "2", "--seq",
                            "16"])
assert len(events["losses"]) == 2 and all(np.isfinite(events["losses"]))
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
