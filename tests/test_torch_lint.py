"""repro_torch.analysis: the architecture linter, its CLI and the default
candidate report, held to the JAX package's ``repro.analysis``."""
import json
import pathlib
import textwrap

import pytest

from repro.analysis import lint as jlint
from repro_torch.analysis import kernel_checks, lint
from repro_torch.analysis.__main__ import main

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _codes(findings):
    return [f.code for f in findings]


def test_installed_tree_is_clean():
    assert lint.source_root() == ROOT / "src" / "repro_torch"
    findings = lint.run_lint(lint.source_root())
    assert findings == [], [str(f) for f in findings]


def test_arch001_kernel_import_outside_allowlist():
    src = "from repro_torch.kernels import sfc_fused as sf\n"
    assert _codes(lint.lint_source(src, "serve/batcher.py")) == ["ARCH001"]
    assert _codes(lint.lint_source(src, "train/trainer.py")) == ["ARCH001"]
    assert _codes(lint.lint_source(
        "import repro_torch.kernels.ops\n", "models/cnn.py")) == ["ARCH001"]
    assert _codes(lint.lint_source(
        "from repro_torch.distributed.conv_spmd import CudaSpmdBackend\n",
        "serve/engine.py")) == ["ARCH001"]
    assert _codes(lint.lint_source(
        "from repro_torch.distributed import conv_spmd\n",
        "launch/mesh.py")) == ["ARCH001"]
    # allowlisted layers may
    for ok in ("api/backends.py", "kernels/ops.py",
               "analysis/kernel_checks.py", "distributed/conv_spmd.py",
               "testing.py"):
        assert lint.lint_source(src, ok) == [], ok
    # importing the sanctioned seams is fine anywhere
    assert lint.lint_source("from repro_torch.api import plan\n",
                            "serve/engine.py") == []
    assert lint.lint_source("from repro_torch.distributed import sharding\n",
                            "train/trainer.py") == []
    # the JAX package's kernels are not the port's
    assert lint.lint_source("from repro.kernels import ops\n",
                            "serve/engine.py") == []


def test_time001_wall_clock_on_serving_paths():
    src = "import time\nt0 = time.time()\n"
    assert _codes(lint.lint_source(src, "serve/engine.py")) == ["TIME001"]
    assert lint.lint_source("import time\nt = time.perf_counter()\n",
                            "serve/engine.py") == []
    # the checkpointer's manifest stamps wall-clock time, off the serve path
    assert lint.lint_source(src, "checkpoint/checkpointer.py") == []


def test_exc001_bare_except():
    src = textwrap.dedent("""
        try:
            x = 1
        except:
            pass
    """)
    assert _codes(lint.lint_source(src, "quant/ptq.py")) == ["EXC001"]


def test_exc002_silent_broad_except():
    silent = textwrap.dedent("""
        try:
            x = 1
        except (ValueError, Exception):
            pass
    """)
    assert _codes(lint.lint_source(silent, "serve/engine.py")) == ["EXC002"]
    loud = textwrap.dedent("""
        try:
            x = 1
        except Exception:
            log("absorbed")
    """)
    assert lint.lint_source(loud, "serve/engine.py") == []
    narrow = textwrap.dedent("""
        try:
            x = 1
        except KeyError:
            pass
    """)
    assert lint.lint_source(narrow, "serve/engine.py") == []


def test_reg001_registration_outside_seams():
    src = "register_algorithm('x', make)\n"
    assert _codes(lint.lint_source(src, "models/cnn.py")) == ["REG001"]
    assert _codes(lint.lint_source(
        "backends.register_backend('gpu', b)\n",
        "distributed/conv_spmd.py")) == ["REG001"]
    assert lint.lint_source(src, "api/registry.py") == []
    assert lint.lint_source("register_backend('cuda_spmd', b)\n",
                            "api/backends.py") == []


@pytest.mark.parametrize("module,name", [
    ("sfc_fused", "fused_geometry"), ("sfc_fused", "FusedGeometry"),
    ("sfc_fused", "depthwise_geometry"), ("sfc_fused", "DepthwiseGeometry"),
    ("sfc_transform", "transform_geometry"),
    ("sfc_transform", "TransformGeometry"),
    ("sfc_tdmm", "tdmm_geometry"), ("sfc_tdmm", "TdmmGeometry"),
    ("sfc_tdmm", "dw_product_geometry"), ("sfc_tdmm", "DwProductGeometry"),
    ("sfc_inverse", "InverseGeometry")])
def test_cost001_geometry_surface_is_allowed(module, name):
    src = f"from repro_torch.kernels.{module} import {name}\n"
    assert lint.lint_source(src, "api/costmodel.py") == []


@pytest.mark.parametrize("src", [
    "from repro_torch.kernels.sfc_tdmm import SMEM_PER_SM\n",
    "from repro_torch.kernels.sfc_fused import fused_geometry, _fits\n",
    "import repro_torch.kernels.sfc_fused\n",
    "b = sf.DW_SMEM_LIMIT_BYTES\n",
    "b = TRANSFORM_SMEM_LIMIT_BYTES\n",
    "n = resident_blocks(256, 0)\n",
    "g = sf._geometry(a, 1, 3, 8, 32, 8, 1, 1, 2, 1)\n",
    "b = sf.B4_SMEM_LIMIT_BYTES\n",
])
def test_cost001_resource_names_are_banned(src):
    assert _codes(lint.lint_source(src, "api/costmodel.py")) == ["COST001"]
    # scoped to costmodel.py: other api files may
    if not src.startswith(("from", "import")):
        assert lint.lint_source(src, "api/backends.py") == []


def test_syntax_error_is_reported_not_raised():
    findings = lint.lint_source("def broken(:\n", "core/x.py")
    assert _codes(findings) == ["LNT000"]


def test_run_lint_over_tmp_tree(tmp_path):
    pkg = tmp_path / "repro_torch"
    (pkg / "serve").mkdir(parents=True)
    (pkg / "api").mkdir()
    (pkg / "serve" / "bad.py").write_text(
        "import time\nfrom repro_torch.kernels import ops\n"
        "t = time.time()\n")
    (pkg / "api" / "good.py").write_text(
        "from repro_torch.kernels import ops\n")
    findings = lint.run_lint(tmp_path)
    assert sorted(_codes(findings)) == ["ARCH001", "TIME001"]
    assert all(f.where.startswith("serve/bad.py") for f in findings)


def test_finding_str_has_code_and_location():
    f = lint.lint_source("x = time.time()\n", "serve/a.py")[0]
    s = str(f)
    assert "TIME001" in s and "serve/a.py:1" in s and "ERROR" in s


# the JAX linter's own snippets, package names as "{pkg}"
_SNIPPETS = [
    ("from {pkg}.kernels import sfc_fused as sf\n", "serve/batcher.py"),
    ("from {pkg}.kernels import sfc_fused as sf\n", "api/backends.py"),
    ("import {pkg}.kernels.ops\n", "models/cnn.py"),
    ("from {pkg}.distributed.conv_spmd import X\n", "serve/engine.py"),
    ("from {pkg}.distributed.conv_spmd import X\n", "testing.py"),
    ("from {pkg}.distributed import conv_spmd\n", "train/trainer.py"),
    ("from {pkg}.distributed import sharding\n", "train/trainer.py"),
    ("from {pkg} import kernels\n", "models/cnn.py"),
    ("from {pkg}.api import plan\n", "serve/engine.py"),
    ("import time\nt0 = time.time()\n", "serve/engine.py"),
    ("import time\nt0 = time.time()\n", "train/trainer.py"),
    ("try:\n    x = 1\nexcept:\n    pass\n", "quant/ptq.py"),
    ("try:\n    x = 1\nexcept Exception:\n    pass\n", "serve/engine.py"),
    ("try:\n    x = 1\nexcept BaseException:\n    '''doc'''\n",
     "core/x.py"),
    ("try:\n    x = 1\nexcept Exception:\n    log(1)\n", "serve/engine.py"),
    ("try:\n    x = 1\nexcept KeyError:\n    pass\n", "serve/engine.py"),
    ("register_algorithm('x', make)\n", "models/cnn.py"),
    ("registry.register_backend('gpu', b)\n", "launch/serve.py"),
    ("register_algorithm('x', make)\n", "api/registry.py"),
    ("register_backend('b', b)\n", "api/backends.py"),
    ("from {pkg}.kernels.sfc_fused import fused_geometry\n",
     "api/costmodel.py"),
    ("from {pkg}.kernels.sfc_fused import FusedGeometry\n",
     "api/costmodel.py"),
    ("import {pkg}.kernels.sfc_fused\n", "api/costmodel.py"),
    ("def broken(:\n", "core/x.py"),
]


@pytest.mark.parametrize("snippet,relpath", _SNIPPETS)
def test_same_codes_as_the_jax_linter(snippet, relpath):
    """The rules shared with the JAX package (all but COST001's resource
    names, which are each package's own) give the same codes on the same
    snippet, the package renamed."""
    got = lint.lint_source(snippet.format(pkg="repro_torch"), relpath)
    want = jlint.lint_source(snippet.format(pkg="repro"), relpath)
    assert sorted(_codes(got)) == sorted(_codes(want))
    assert [f.where for f in got] == [f.where for f in want]


def test_check_exits_0_on_the_port_and_1_on_a_planted_breach(tmp_path,
                                                              capsys):
    assert main(["--check"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("OK")
    pkg = tmp_path / "repro_torch" / "serve"
    pkg.mkdir(parents=True)
    (pkg / "engine.py").write_text(
        "from repro_torch.kernels import sfc_fused\n")
    assert main(["--check", "--root", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "ARCH001" in out and "serve/engine.py:1" in out
    assert out.rstrip().endswith("FAILED: 1 ERROR finding(s)")
    # without --check the breach is advisory
    assert main(["--root", str(tmp_path)]) == 0


def test_certificates_equal_the_jax_clis(tmp_path):
    from repro.analysis.__main__ import main as jmain
    assert main(["--certificates", str(tmp_path / "port.json")]) == 0
    assert jmain(["--certificates", str(tmp_path / "jax.json")]) == 0
    port = json.loads((tmp_path / "port.json").read_text())
    assert port == json.loads((tmp_path / "jax.json").read_text())
    assert len(port) == 9
    assert (tmp_path / "port.json").read_bytes() \
        == (tmp_path / "jax.json").read_bytes()


def test_default_candidate_report_has_no_error():
    findings = kernel_checks.default_candidate_report()
    # B4 takes every candidate at every tile (sfc6_7's t = 12 at k_block
    # 64 or cout_block 16 with one weight stage, and 8 tiles a block), so
    # the report is empty and the pre-flight drops nothing
    assert findings == [], [str(f) for f in findings]
    from repro_torch.api import registry
    from repro_torch.api.spec import ConvSpec
    from repro_torch.api.tuning import DEFAULT_CANDIDATES
    from repro_torch.quant import INT8_FREQ
    spec = ConvSpec(kernel_size=3, in_channels=64, out_channels=128,
                    spatial=(28, 28), quant=INT8_FREQ)
    for name in ("sfc6_7", "sfc6_6", "sfc4_4"):
        algo = registry.get_algorithm(name)
        ok, rejected = kernel_checks.check_candidates(
            spec, algo, DEFAULT_CANDIDATES)
        assert rejected == [] and ok == list(DEFAULT_CANDIDATES)
        assert not any(kernel_checks.tile_refuses(algo, c)
                       for c in DEFAULT_CANDIDATES)


def test_a_config_that_breaks_a_limit_is_a_kc_finding():
    from repro_torch.api import registry
    from repro_torch.api.tuning import KernelConfig
    algo = registry.get_algorithm("sfc6_6")
    # the staged trio at 4096 images of 512x512: B2's grid beyond CUDA's
    # y limit, B3's thread index beyond 31 bits
    got = kernel_checks.check_config(
        algo, KernelConfig(datapath="staged", k_block=None), 4096, 512, 512,
        64, 64)
    assert _codes(got) == ["KC002", "KC002"]
    assert all(f.severity == kernel_checks.ERROR for f in got)
    # B4 finds no geometry for so many tile groups
    got = kernel_checks.check_config(algo, KernelConfig(), 4096, 512, 512,
                                     64, 64)
    assert _codes(got) == ["KC004"]
    # knobs no kernel takes
    got = kernel_checks.check_config(algo, KernelConfig(cout_block=32), 1,
                                     14, 14, 128, 128)
    assert _codes(got) == ["KC004"]
    assert not kernel_checks.tile_refuses(algo, KernelConfig(k_block=64))
    assert not kernel_checks.tile_refuses(registry.get_algorithm("sfc6_7"),
                                          KernelConfig(k_block=64))
    assert not kernel_checks.tile_refuses(registry.get_algorithm("sfc6_7"),
                                          KernelConfig(cout_block=16))
