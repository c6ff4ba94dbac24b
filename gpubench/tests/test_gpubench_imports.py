"""No JAX in a run: the whole-name check, what a run imports, and the
command's refusals on a host without the cell's CUDA devices or without
the program."""

import os
import shutil
import subprocess
import sys

import pytest

from gpubench import run, spec


@pytest.mark.parametrize("modules,found", [
    (["avtex_torch", "avtex_torch.nn.slowfast", "torch"], []),
    (["avtex", "avtex_torch"], ["avtex"]),
    (["avtex.nn.slowfast"], ["avtex"]),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "avtexx", "flaxen"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, found):
    assert run.forbidden_modules(modules) == found


def _python(code, cwd=spec.ROOT, **kwargs):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300,
                          **kwargs)


def test_a_run_imports_no_jax():
    code = (
        "import sys\n"
        "from gpubench import run, control\n"
        "r = run.run_cell('embed.r3d18.fresh', 5, 0.2, False, device='cpu',"
        " overrides={'config': {'width': 8, 'img_size': 32},"
        " 'traffic': {'video': {'seconds': 3, 'fps': 30, 'size': 32,"
        " 'pool': 1}, 'batch_size': 8, 'check_rows': 4}})\n"
        "for w in ('train', 'embed'):\n"
        "    from gpubench import spec\n"
        "    spec.load_module('drivers', w)\n"
        "print(run.forbidden_modules())\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_command_refuses_without_a_cuda_device():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "gpubench", "--workload", "embed.r3d18.fresh",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_command_fails_without_the_program(tmp_path):
    shutil.copytree(spec.PKG, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "gpubench", "--workload", "embed.r3d18.fresh",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
