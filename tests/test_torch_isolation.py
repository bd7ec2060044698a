"""The PyTorch port stands alone: no module of `freefine_tpu_torch` nor its
scripts (`chip_smoke.py`, `bench_torch.py`, `scripts/tca_graph_times.py`,
`scripts/gn_plan_sweep.py`, `scripts/gn_route_paired.py`,
`scripts/flash_f32_accuracy.py`) imports `jax`, `flax` or the JAX package,
and importing the port leaves `jax` out of `sys.modules`.  The card's machine has neither `safetensors`, PIL, cv2 nor
torchvision: no port module imports `safetensors`, cv2 or torchvision, PIL
is imported only inside `utils.vis.save_intermediate_gif`, and importing
GeoBench's metrics (`metrics.*`, their models and `utils.image_io`) loads
none of them."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "freefine_tpu")


def _sources():
    files = sorted((ROOT / "freefine_tpu_torch").rglob("*.py")) + [
        ROOT / name for name in ("chip_smoke.py", "bench_torch.py", "scripts/tca_graph_times.py",
                                 "scripts/gn_plan_sweep.py", "scripts/gn_route_paired.py",
                                 "scripts/flash_f32_accuracy.py")]
    assert len(files) > 10
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [n for n in _imported_roots(path) if _forbidden(n)]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_matcher():
    assert _forbidden("freefine_tpu.ops.attention") and _forbidden("jax.numpy")
    assert not _forbidden("freefine_tpu_torch.ops") and not _forbidden("jaxtyping_free")


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import freefine_tpu_torch.pipeline, freefine_tpu_torch.weights\n"
        "import freefine_tpu_torch.ops.geometry, freefine_tpu_torch.ops.group_norm\n"
        "import freefine_tpu_torch.utils.profiling, freefine_tpu_torch.utils.vis\n"
        "import freefine_tpu_torch.utils.attn_store, freefine_tpu_torch.masks\n"
        "import freefine_tpu_torch.models.dit, freefine_tpu_torch.models.t5\n"
        "import freefine_tpu_torch.models.ip_adapter\n"
        "import freefine_tpu_torch.models.dinov2, freefine_tpu_torch.models.depth_anything\n"
        "import freefine_tpu_torch.models.efficient_sam, freefine_tpu_torch.ops.resize\n"
        "import freefine_tpu_torch.ops.point_splat, freefine_tpu_torch.ops.geodiff_warp\n"
        "import freefine_tpu_torch.data.author3d, freefine_tpu_torch.data.datagen\n"
        "import freefine_tpu_torch.models.video_unet, freefine_tpu_torch.models.sv3d\n"
        "import freefine_tpu_torch.models.clip_image, freefine_tpu_torch.models.u2net\n"
        "import freefine_tpu_torch.models.raft, freefine_tpu_torch.ops.flow\n"
        "import freefine_tpu_torch.ops.dift, freefine_tpu_torch.baselines.motion_guidance\n"
        "import freefine_tpu_torch.baselines.region_drag, freefine_tpu_torch.baselines.design_edit\n"
        "import freefine_tpu_torch.baselines.self_guidance\n"
        "import freefine_tpu_torch.baselines.geo_diffuser, freefine_tpu_torch.baselines\n"
        "import freefine_tpu_torch.baselines.diffusion_handles\n"
        "import freefine_tpu_torch.baselines.drag_diffusion, freefine_tpu_torch.baselines.eval\n"
        "import freefine_tpu_torch.metrics.md, freefine_tpu_torch.metrics.main\n"
        "import freefine_tpu_torch.metrics.preprocess, freefine_tpu_torch.metrics.common\n"
        "import freefine_tpu_torch.metrics.fid, freefine_tpu_torch.metrics.consistency\n"
        "import freefine_tpu_torch.metrics.scoring, freefine_tpu_torch.metrics.wrap_error\n"
        "import freefine_tpu_torch.models.inception, freefine_tpu_torch.models.blip\n"
        "import freefine_tpu_torch.models.open_clip_text, freefine_tpu_torch.utils.image_io\n"
        "import freefine_tpu_torch.data.geobench\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'freefine_tpu', 'safetensors', 'PIL', 'cv2', 'torchvision')]\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == ""


def _imports_with_scope(path: Path):
    """(imported module, names of the enclosing functions) of every import."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def walk(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from walk(child, scope + (child.name,))
            elif isinstance(child, ast.Import):
                for alias in child.names:
                    yield alias.name, scope
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                yield child.module, scope
            else:
                yield from walk(child, scope)

    yield from walk(tree, ())


def test_no_safetensors_and_pil_only_inside_the_gif_writer():
    files = sorted((ROOT / "freefine_tpu_torch").rglob("*.py"))
    pil = []
    for path in files:
        for name, scope in _imports_with_scope(path):
            root = name.split(".")[0]
            assert root not in ("safetensors", "cv2", "torchvision"), \
                f"{path.relative_to(ROOT)} imports {name}"
            if root == "PIL":
                pil.append((str(path.relative_to(ROOT)), scope))
    assert pil and all(p == ("freefine_tpu_torch/utils/vis.py", ("save_intermediate_gif",))
                       for p in pil), pil
