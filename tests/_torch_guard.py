"""Run a script of the port in a fresh interpreter and hold it to loading
no JAX: the guards of tests/test_torch_guards*.py."""

import os
import subprocess
import sys
from pathlib import Path

from _torch_threads import THREADS

ROOT = Path(__file__).resolve().parents[1]


def run_without_jax(script):
    """Run ``script`` (which prints ``FOREIGN`` and the foreign modules it
    finds in sys.modules) from the repository's root; it must exit 0 and
    find none."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS=str(THREADS))
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout, out.stdout[-2000:]
