"""What the GPU entry points promise without a GPU: the compile-cache
location, chip_smoke.py's device guard and result line, refusal to run on
the CPU, and no code path left for another accelerator's kernels."""

import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import pytest

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _python(code, **env_over):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **env_over)
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


_PRINT_CACHE = ("import sos_slam_tpu, jax; "
                "print(jax.config.jax_compilation_cache_dir)")


def test_cache_dir_follows_env_var(tmp_path):
    r = _python(_PRINT_CACHE, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == str(tmp_path)


def test_cache_dir_default_is_fixed_inside_checkout():
    runs = [_python(_PRINT_CACHE) for _ in range(2)]
    for r in runs:
        assert r.returncode == 0, r.stderr
    paths = [r.stdout.strip().splitlines()[-1] for r in runs]
    assert paths[0] == paths[1]
    rel = pathlib.Path(paths[0]).relative_to(ROOT)
    assert rel.parts[0] == ".jax_cache"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_device_guard_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(jax.devices("cpu"))
    assert e.value.code != 0


def test_result_line_has_exactly_the_contract_keys():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()])
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_points_exit_nonzero_on_cpu(script):
    r = subprocess.run([sys.executable, script], cwd=ROOT,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout


def test_no_code_for_other_accelerators():
    """No module imports the TPU Pallas dialect or branches on a TPU
    backend name."""
    pat = re.compile(r"pallas\s*(import|\.)\s*tpu|pltpu"
                     r"|['\"]tpu['\"]")
    hits = []
    for path in (ROOT / "sos_slam_tpu").rglob("*.py"):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if pat.search(line):
                hits.append(f"{path.relative_to(ROOT)}:{i}: {line.strip()}")
    assert not hits, hits
