"""The port's LM side on a mesh against the reference's on 4 devices:
``tests/torch_mesh_serve_check.py`` in a subprocess a group (4 fake CPU
devices for the reference; the port on CPU meshes of logical shards):
the MoE layer's expert-parallel routes on four meshes in f32 and bf16
(tokens dropped at a capacity), the all-to-all route's gradients, six
families' smoke configs served on (2, 2), and qwen3-moe-30b-a3b's
launcher paths (``generate`` and three train steps) on the launchers'
default (1, 1) mesh."""
import os
import subprocess
import sys

import pytest


@pytest.mark.parametrize("group", ["routes", "grads", "serve", "launchers"])
def test_matches_reference_on_four_devices(group):
    """``tests/torch_mesh_serve_check.py GROUP`` in a subprocess (4 fake
    devices for the reference): the mesh routes, their gradients, six
    families served on (2, 2), and the launchers' paths on (1, 1)."""
    script = os.path.join(os.path.dirname(__file__),
                          "torch_mesh_serve_check.py")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    out = subprocess.run([sys.executable, script, group], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    assert "ALL OK" in out.stdout
