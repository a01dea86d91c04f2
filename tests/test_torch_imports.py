"""The port stands alone: no module of ``paddle_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package
(``paddle_tpu``), not even its JAX-free modules. Checked on the source
with an AST scan, so an import inside a function counts too."""

import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                _forbidden(str(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("paddle_tpu_torch/inference/llm.py",
                 "paddle_tpu_torch/ops/paged_attention.py",
                 "paddle_tpu_torch/ops/flash_attention.py",
                 "paddle_tpu_torch/ops/fused_xent.py",
                 "paddle_tpu_torch/amp/__init__.py",
                 "paddle_tpu_torch/nn/clip.py",
                 "paddle_tpu_torch/optimizer/lr.py",
                 "paddle_tpu_torch/optimizer/optimizer.py",
                 "paddle_tpu_torch/hapi/model.py",
                 "paddle_tpu_torch/models/gpt.py",
                 "paddle_tpu_torch/inference/kv_transfer.py",
                 "paddle_tpu_torch/reliability/__init__.py",
                 "paddle_tpu_torch/reliability/faults.py",
                 "paddle_tpu_torch/reliability/retry.py",
                 "paddle_tpu_torch/observability/__init__.py",
                 "paddle_tpu_torch/observability/audit.py",
                 "paddle_tpu_torch/observability/exporters.py",
                 "paddle_tpu_torch/observability/flight.py",
                 "paddle_tpu_torch/observability/goodput.py",
                 "paddle_tpu_torch/observability/memory.py",
                 "paddle_tpu_torch/observability/metrics.py",
                 "paddle_tpu_torch/observability/perf.py",
                 "paddle_tpu_torch/observability/propagation.py",
                 "paddle_tpu_torch/observability/server.py",
                 "paddle_tpu_torch/observability/tracing.py",
                 "paddle_tpu_torch/observability/slo.py",
                 "paddle_tpu_torch/distributed/tcp_store.py",
                 "paddle_tpu_torch/serving/autoscaler.py",
                 "paddle_tpu_torch/serving/breaker.py",
                 "paddle_tpu_torch/serving/fleet.py",
                 "paddle_tpu_torch/serving/overload.py",
                 "paddle_tpu_torch/serving/replica.py",
                 "paddle_tpu_torch/serving/router.py",
                 "chip_smoke.py"):
        assert must in names
