#!/usr/bin/env python3
"""One checkout's qwen3-1.7b serving and training phases on one card, for
comparing commits in one call of the card, in turns:

    for d in parent change change parent; do python3 chip_ab.py $d; done

Each ``DIR`` is a checkout (a ``git archive`` of a commit, say).  The run
imports that checkout's own ``chip_smoke.py`` and ``src/``, builds its
flash kernels into its ``build/``, drives ``lm_phase`` (qwen3-1.7b served
at full width) and ``train_phase`` (trained at full width, the
checkpointed loop included) and prints one line ``AB {json}``: the card
(``nvidia-smi``'s name and power limit), prefill ms, decode ms a step, the
serving peak, the training step ms with one microbatch and with two, the
six losses, the training peak and the flash forward's ms.  Every check of
those phases holds as in ``chip_smoke.py``; it exits non-zero if one
fails or no card is present.
"""
import json
import os
import subprocess
import sys


def main(root: str) -> int:
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    if os.path.dirname(os.path.abspath(cs.__file__)) != root:
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.flash_fwd()
    _build.flash_bwd()
    device = torch.device("cuda", 0)
    peaks = cs.peaks_for(torch.cuda.get_device_name(0))
    serve = cs.lm_phase(device, peaks)
    train = cs.train_phase(device, peaks)["kernels"][0]
    print("AB " + json.dumps({
        "root": root, "card": card, "prefill_ms": serve["prefill_ms"],
        "decode_ms_per_step": serve["decode_ms_per_step"],
        "serve_peak_memory_gb": serve["serve_peak_memory_gb"],
        "train_step_ms": train["train_step_ms"],
        "train_mb2_step_ms": train.get("train_mb2_step_ms"),
        "train_losses": train["train_losses"],
        "train_peak_memory_gb": train["train_peak_memory_gb"],
        "flash_fwd_ms": float(serve["ms"])}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
