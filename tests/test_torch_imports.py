"""The port stands alone: no file of unidisc_tpu_torch/ and not
chip_smoke.py imports JAX, flax or the JAX package, nor PIL, safetensors,
sklearn, transformers or tokenizers (the card's machine has none of them),
and importing the package needs neither nvcc nor CUDA."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "unidisc_tpu",
             "PIL", "safetensors", "sklearn", "transformers", "tokenizers"}
FILES = sorted(str(p.relative_to(ROOT))
               for p in (ROOT / "unidisc_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py"]


def imported_roots(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


# the modules of the training slice, each of which must be in FILES
TRAINING_SLICE = [
    "unidisc_tpu_torch/diffusion/subs.py",
    "unidisc_tpu_torch/diffusion/forward_process.py",
    "unidisc_tpu_torch/diffusion/loss.py",
    "unidisc_tpu_torch/training/train_state.py",
    "unidisc_tpu_torch/training/checkpoint.py",
    "unidisc_tpu_torch/training/trainer.py",
    "unidisc_tpu_torch/data/synthetic.py",
    "unidisc_tpu_torch/utils/monitor.py",
    "unidisc_tpu_torch/utils/logging.py",
    "unidisc_tpu_torch/train.py",
    "unidisc_tpu_torch/profile_train.py",
]


def test_training_slice_is_checked():
    assert set(TRAINING_SLICE) <= set(FILES)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert (ROOT / f"unidisc_tpu_torch/ops/csrc/{name}.cu").exists()
    # the dq kernel's first source, replaced by flash_bwd_dq.cu
    assert not (ROOT / "unidisc_tpu_torch/ops/csrc/flash_bwd.cu").exists()


def chip_smoke_kernels():
    """chip_smoke.py's KERNELS table."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "KERNELS"):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no KERNELS table")


def chip_smoke_sources():
    """The "source" of every kernel in chip_smoke.py's KERNELS table."""
    return {name: meta["source"]
            for name, meta in chip_smoke_kernels().items()}


CSRC = sorted(p.name for p in (ROOT / "unidisc_tpu_torch/ops/csrc")
              .glob("*.cu"))


@pytest.mark.parametrize("source", CSRC)
def test_every_kernel_source_is_in_chip_smoke(source):
    named = {pathlib.Path(s).name for s in chip_smoke_sources().values()}
    assert source in named


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv", "int8_matmul",
                                  "fused_qmm"])
def test_chip_smoke_names_an_existing_source(name):
    source = chip_smoke_sources()[name]
    assert (ROOT / source).exists() and source.endswith(f"/{name}.cu")


def test_chip_smoke_names_the_dynamic_quantize_kernel():
    # the per-row quantize of the int8 path is an entry of fused_qmm.cu
    meta = chip_smoke_kernels()["dynamic_quantize"]
    assert meta["source"] == "unidisc_tpu_torch/ops/csrc/fused_qmm.cu"
    assert (ROOT / meta["source"]).exists()
    assert "row_quantize_div" in (ROOT / meta["source"]).read_text()
    assert meta["replaces"] == "unidisc_tpu/ops/quant.py:51"


# the modules of the int8 serving slice
INT8_SLICE = [
    "unidisc_tpu_torch/ops/quant.py",
    "unidisc_tpu_torch/ops/int8_matmul.py",
    "unidisc_tpu_torch/ops/fused_qmm.py",
]


def test_int8_slice_is_checked():
    assert set(INT8_SLICE) <= set(FILES)
    for name in ("int8_matmul", "fused_qmm"):
        assert (ROOT / f"unidisc_tpu_torch/ops/csrc/{name}.cu").exists()


# the modules of the sampler-program slice: the generic sampler, the KV
# cache, the conditioning-frozen t2i sampler and the captured programs
SAMPLER_SLICE = [
    "unidisc_tpu_torch/sampling/sampler.py",
    "unidisc_tpu_torch/sampling/ar_sampler.py",
    "unidisc_tpu_torch/sampling/t2i_fast.py",
    "unidisc_tpu_torch/sampling/graph.py",
    "unidisc_tpu_torch/serving/engine.py",
    "unidisc_tpu_torch/models/dit.py",
    "unidisc_tpu_torch/ops/quant.py",
]


def test_sampler_slice_is_checked():
    assert set(SAMPLER_SLICE) <= set(FILES)
    # the card tests of the slice import no JAX either
    for name in ("test_torch_graph_cuda.py", "test_torch_flash_cuda.py",
                 "test_torch_int8_cuda.py"):
        path = f"tests/{name}"
        assert not sorted(set(imported_roots(path)) & FORBIDDEN), path


# the modules of the pixels slice: the codecs, the PNG and safetensors
# readers, the engine's loading paths and the generate CLI
CODEC_SLICE = [
    "unidisc_tpu_torch/tokenizers/vqgan.py",
    "unidisc_tpu_torch/tokenizers/image_codecs.py",
    "unidisc_tpu_torch/utils/png.py",
    "unidisc_tpu_torch/serving/engine.py",
    "unidisc_tpu_torch/models/port.py",
    "unidisc_tpu_torch/training/checkpoint.py",
    "unidisc_tpu_torch/generate.py",
]


def test_codec_slice_is_checked():
    assert set(CODEC_SLICE) <= set(FILES)
    path = "tests/test_torch_codec_cuda.py"
    assert not sorted(set(imported_roots(path)) & FORBIDDEN), path


# the modules of the serving front door: the server, the batchers, the
# client, the resize and scaffold decoding
SERVING_SLICE = [
    "unidisc_tpu_torch/serving/server.py",
    "unidisc_tpu_torch/serving/batcher.py",
    "unidisc_tpu_torch/serving/client.py",
    "unidisc_tpu_torch/serving/rolling.py",
    "unidisc_tpu_torch/serving/engine.py",
    "unidisc_tpu_torch/sampling/scaffold.py",
    "unidisc_tpu_torch/sampling/graph.py",
    "unidisc_tpu_torch/utils/resize.py",
]


def test_serving_slice_is_checked():
    assert set(SERVING_SLICE) <= set(FILES)
    assert (ROOT / "unidisc_tpu_torch/serving/webui.html").exists()
    path = "tests/test_torch_rolling_cuda.py"
    assert not sorted(set(imported_roots(path)) & FORBIDDEN), path
    # the client stays on the standard library
    roots = set(imported_roots("unidisc_tpu_torch/serving/client.py"))
    assert roots <= {"__future__", "argparse", "base64", "json",
                     "urllib"}, roots


# the modules of the AR serving slice: the decode loop, OpenELM, the
# continuous batcher, speculative and prompt-lookup decoding, the engines'
# AR routes
AR_SLICE = [
    "unidisc_tpu_torch/sampling/ar_sampler.py",
    "unidisc_tpu_torch/models/elm.py",
    "unidisc_tpu_torch/serving/continuous.py",
    "unidisc_tpu_torch/serving/speculative.py",
    "unidisc_tpu_torch/serving/engine.py",
    "unidisc_tpu_torch/serving/server.py",
    "unidisc_tpu_torch/sampling/graph.py",
    "unidisc_tpu_torch/models/port.py",
    "unidisc_tpu_torch/ops/quant.py",
]


def test_ar_slice_is_checked():
    assert set(AR_SLICE) <= set(FILES)
    path = "tests/test_torch_ar_cuda.py"
    assert not sorted(set(imported_roots(path)) & FORBIDDEN), path


# the modules of the training-objectives and data slice: the legacy
# losses, token shards, streaming and the CLI that trains on them
DATA_SLICE = [
    "unidisc_tpu_torch/diffusion/legacy.py",
    "unidisc_tpu_torch/data/token_shards.py",
    "unidisc_tpu_torch/data/streaming.py",
    "unidisc_tpu_torch/training/train_state.py",
    "unidisc_tpu_torch/models/dit.py",
    "unidisc_tpu_torch/train.py",
]


def test_data_slice_is_checked():
    assert set(DATA_SLICE) <= set(FILES)
    # the port keeps its own copies of the pure-numpy data modules
    for path in DATA_SLICE:
        assert "unidisc_tpu" not in set(imported_roots(path)), path


# the modules of the rest of training: the optimizers, Muon, muP, the
# flax-leaf layout, LoRA, host offload, distillation, the supervisor
TRAIN_REST_SLICE = [
    "unidisc_tpu_torch/training/optimizers.py",
    "unidisc_tpu_torch/training/layout.py",
    "unidisc_tpu_torch/training/muon.py",
    "unidisc_tpu_torch/training/mup.py",
    "unidisc_tpu_torch/training/lora.py",
    "unidisc_tpu_torch/training/offload.py",
    "unidisc_tpu_torch/training/distill.py",
    "unidisc_tpu_torch/training/supervisor.py",
    "unidisc_tpu_torch/training/trainer.py",
    "unidisc_tpu_torch/training/train_state.py",
    "unidisc_tpu_torch/models/dit.py",
    "unidisc_tpu_torch/serving/engine.py",
]


def test_train_rest_slice_is_checked():
    assert set(TRAIN_REST_SLICE) <= set(FILES)
    # the supervisor stays on the standard library
    roots = set(imported_roots("unidisc_tpu_torch/training/supervisor.py"))
    assert roots <= {"__future__", "argparse", "dataclasses", "json",
                     "signal", "subprocess", "sys", "time", "typing"}, roots


# the modules of the interleaved slice: packing (Python and native), the
# ragged streams, the DIT's packed-batch arguments, the interleaved engine
# route, and the samplers left (caching, extras, transfusion)
INTERLEAVED_SLICE = [
    "unidisc_tpu_torch/models/rotary.py",
    "unidisc_tpu_torch/ops/attention.py",
    "unidisc_tpu_torch/models/dit.py",
    "unidisc_tpu_torch/models/port.py",
    "unidisc_tpu_torch/data/interleaved.py",
    "unidisc_tpu_torch/data/native_packer.py",
    "unidisc_tpu_torch/data/streaming.py",
    "unidisc_tpu_torch/tokenizers/interleaved_text.py",
    "unidisc_tpu_torch/training/train_state.py",
    "unidisc_tpu_torch/train.py",
    "unidisc_tpu_torch/sampling/sampler.py",
    "unidisc_tpu_torch/serving/engine.py",
    "unidisc_tpu_torch/serving/server.py",
    "unidisc_tpu_torch/sampling/caching.py",
    "unidisc_tpu_torch/sampling/extras.py",
    "unidisc_tpu_torch/models/continuous.py",
    "unidisc_tpu_torch/sampling/continuous.py",
]


def test_interleaved_slice_is_checked():
    assert set(INTERLEAVED_SLICE) <= set(FILES)
    for path in INTERLEAVED_SLICE:
        assert "unidisc_tpu" not in set(imported_roots(path)), path
    # the native packer builds the shared C++ source into the port's
    # build directory; it keeps no binding of the JAX package's
    assert (ROOT / "native/packer.cpp").exists()
    binding = (ROOT / "unidisc_tpu_torch/data/native_packer.py").read_text()
    assert "BUILD_DIR" in binding and "packer.so" not in binding


# the modules of the DIT variants and the data tail: MoE, the variant
# branches of the DIT, train step, engine and shape rules, prefetch,
# precompute and the dataset adapters
VARIANTS_SLICE = [
    "unidisc_tpu_torch/models/moe.py",
    "unidisc_tpu_torch/models/dit.py",
    "unidisc_tpu_torch/models/port.py",
    "unidisc_tpu_torch/training/train_state.py",
    "unidisc_tpu_torch/training/layout.py",
    "unidisc_tpu_torch/training/lora.py",
    "unidisc_tpu_torch/sampling/sampler.py",
    "unidisc_tpu_torch/serving/engine.py",
    "unidisc_tpu_torch/data/prefetch.py",
    "unidisc_tpu_torch/data/precompute.py",
    "unidisc_tpu_torch/data/hf_datasets.py",
]


def test_variants_slice_is_checked():
    assert set(VARIANTS_SLICE) <= set(FILES)
    for path in VARIANTS_SLICE:
        assert "unidisc_tpu" not in set(imported_roots(path)), path
    # the dataset adapters import datasets and PIL only where they run
    # (the card's machine has neither)
    roots = set(imported_roots("unidisc_tpu_torch/data/hf_datasets.py"))
    assert not roots & {"datasets", "PIL"}, roots


# the modules of the device mesh: the process-group helpers, the mesh and
# its sharding rules, the collectives, ring attention, the sequence-
# parallel context and SPMD sampling, and the entry points they enter
MESH_SLICE = [
    "unidisc_tpu_torch/utils/dist.py",
    "unidisc_tpu_torch/parallel/__init__.py",
    "unidisc_tpu_torch/parallel/comm.py",
    "unidisc_tpu_torch/parallel/mesh.py",
    "unidisc_tpu_torch/parallel/pipeline.py",
    "unidisc_tpu_torch/parallel/ring_attention.py",
    "unidisc_tpu_torch/parallel/seq_parallel.py",
    "unidisc_tpu_torch/parallel/sample.py",
    "unidisc_tpu_torch/models/dit.py",
    "unidisc_tpu_torch/models/moe.py",
    "unidisc_tpu_torch/training/train_state.py",
    "unidisc_tpu_torch/training/trainer.py",
    "unidisc_tpu_torch/serving/engine.py",
    "unidisc_tpu_torch/serving/server.py",
    "unidisc_tpu_torch/train.py",
]


def test_mesh_slice_is_checked():
    assert set(MESH_SLICE) <= set(FILES)
    for path in MESH_SLICE + ["tests/torch_mesh_worker.py"]:
        assert not sorted(set(imported_roots(path)) & FORBIDDEN), path
    # importing the mesh modules joins no process group and touches no card
    code = ("import torch.distributed as dist\n"
            "import unidisc_tpu_torch.utils.dist\n"
            "import unidisc_tpu_torch.parallel.mesh\n"
            "import unidisc_tpu_torch.parallel.pipeline\n"
            "import unidisc_tpu_torch.parallel.ring_attention\n"
            "import unidisc_tpu_torch.parallel.sample\n"
            "import unidisc_tpu_torch.parallel.seq_parallel\n"
            "from unidisc_tpu_torch.utils import dist as udist\n"
            "assert not dist.is_initialized()\n"
            "assert udist.world_size() == 1 and udist.is_main_process()\n"
            "assert not udist.initialize(device='cpu')\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   env={"PATH": "/nonexistent", "CUDA_VISIBLE_DEVICES": ""})


# the modules of the evaluation slice: the metric battery, its judges and
# their tokenizer, scoring, auto-enhance, the eval CLI and the utils left
EVAL_SLICE = [
    "unidisc_tpu_torch/eval/__init__.py",
    "unidisc_tpu_torch/eval/fid.py",
    "unidisc_tpu_torch/eval/judge_nets.py",
    "unidisc_tpu_torch/eval/judges.py",
    "unidisc_tpu_torch/eval/harness.py",
    "unidisc_tpu_torch/eval/rewards.py",
    "unidisc_tpu_torch/eval/auto_enhance.py",
    "unidisc_tpu_torch/eval/scoring.py",
    "unidisc_tpu_torch/eval_run.py",
    "unidisc_tpu_torch/tokenizers/bpe.py",
    "unidisc_tpu_torch/utils/caption_llm.py",
    "unidisc_tpu_torch/utils/profiling.py",
    "unidisc_tpu_torch/utils/viz.py",
    "unidisc_tpu_torch/utils/resize.py",
]


def test_eval_slice_is_checked():
    assert set(EVAL_SLICE) <= set(FILES)
    # every module of the JAX package's eval/ has its counterpart
    jax_eval = {p.name for p in (ROOT / "unidisc_tpu/eval").glob("*.py")}
    port_eval = {p.name for p in (ROOT / "unidisc_tpu_torch/eval")
                 .glob("*.py")}
    assert jax_eval <= port_eval, sorted(jax_eval - port_eval)
    # caption_llm stays on numpy and the standard library
    roots = set(imported_roots("unidisc_tpu_torch/utils/caption_llm.py"))
    assert roots <= {"__future__", "re", "typing", "numpy"}, roots


# the modules of the tokenizer slice: MAGVITv2, TiTok, the video VQVAE,
# the Chameleon stream tokenizer, the structural remap, the HF text
# tokenizers, and the factories that reach them
TOKENIZER_SLICE = [
    "unidisc_tpu_torch/tokenizers/magvit.py",
    "unidisc_tpu_torch/tokenizers/titok.py",
    "unidisc_tpu_torch/tokenizers/video.py",
    "unidisc_tpu_torch/tokenizers/chameleon.py",
    "unidisc_tpu_torch/tokenizers/remap.py",
    "unidisc_tpu_torch/tokenizers/hf_text.py",
    "unidisc_tpu_torch/tokenizers/text.py",
    "unidisc_tpu_torch/tokenizers/image_codecs.py",
]


def test_tokenizer_slice_is_checked():
    assert set(TOKENIZER_SLICE) <= set(FILES)
    for path in TOKENIZER_SLICE:
        assert not sorted(set(imported_roots(path)) & FORBIDDEN), path
    # every module of the JAX package's tokenizers/ has its counterpart
    jax_tok = {p.name for p in (ROOT / "unidisc_tpu/tokenizers")
               .glob("*.py")}
    port_tok = {p.name for p in (ROOT / "unidisc_tpu_torch/tokenizers")
                .glob("*.py")}
    assert jax_tok <= port_tok, sorted(jax_tok - port_tok)


@pytest.mark.parametrize("path", FILES)
def test_no_jax_imports(path):
    # the first dotted component must not be a forbidden name exactly:
    # unidisc_tpu_torch starts with unidisc_tpu but is the port itself
    bad = sorted(set(imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_package_imports_without_cuda_or_nvcc():
    code = ("import sys, torch, importlib, pkgutil\n"
            "import unidisc_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'unidisc_tpu')]\n"
            "assert not bad, bad\n"
            "from unidisc_tpu_torch.ops import _build\n"
            "assert not _build._libs\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   env={"PATH": "/nonexistent", "CUDA_VISIBLE_DEVICES": "",
                        "CUDA_HOME": "/nonexistent"})
