"""Run provenance for benchmark rows (counterpart of ``run_metadata`` in
``jvector_tpu/bench/diagnostics.py``; reference ``GitInfo`` /
``SysInfoWriter``).

Every row a benchmark emits carries the git sha, the device it ran on and
the library versions, so a number can be traced to the code, machine and
parameters that produced it.  On a CUDA device, ``device`` is the card's
name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import subprocess
import time

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" on
    the CPU."""
    if dev.type != "cuda":
        return str(dev)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0] if len(out) == 1 else out[dev.index or 0]


def _git(*args: str) -> str:
    try:
        return subprocess.run(["git", *args], capture_output=True, timeout=5, cwd=_ROOT).stdout.decode().strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def run_metadata(config: dict | None = None, device: torch.device | str = "cuda") -> dict:
    """Git sha and dirty flag, the device, torch and CUDA versions, host
    info and, with ``config``, a hash of it."""
    dev = torch.device(device)
    meta = {
        "git_sha": _git("rev-parse", "HEAD")[:12],
        "git_dirty": bool(_git("status", "--porcelain")),
        "device": device_label(dev),
        "backend": dev.type,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "hostname": platform.node(),
        "platform": platform.platform(),
        "cpu_count": os.cpu_count(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
    if config is not None:
        blob = json.dumps(config, sort_keys=True, default=str).encode()
        meta["config_hash"] = hashlib.sha256(blob).hexdigest()[:12]
    return meta
