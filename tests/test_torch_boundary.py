"""Guards of the port's boundary, for every later slice: the package and
``chip_smoke.py`` import neither JAX nor ``petastorm_tpu``; entry points
never fall back to the CPU silently; the CPU path never counts a kernel
launch."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "petastorm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module):
    """True for ``jax``/``jax.*``/``jaxlib`` and ``petastorm_tpu``/
    ``petastorm_tpu.*`` — not for ``petastorm_tpu_torch``."""
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "petastorm_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_forbidden_prefix_check():
    assert _forbidden("jax.numpy") and _forbidden("petastorm_tpu.ops")
    assert _forbidden("petastorm_tpu") and _forbidden("jax")
    assert not _forbidden("petastorm_tpu_torch.ops.flash_attention")
    assert not _forbidden("jaxtyping_like_name")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax_and_no_jax_package(path):
    bad = [f"{path.relative_to(REPO)}:{line} imports {mod}"
           for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, bad


def test_import_and_cpu_forward_leave_jax_unloaded():
    code = textwrap.dedent("""
        import sys, torch
        import petastorm_tpu_torch
        from petastorm_tpu_torch.ops.flash_attention import flash_attention
        from petastorm_tpu_torch.models.long_context_lm import init_lm_params
        g = torch.Generator().manual_seed(0)
        q = torch.randn(1, 12, 2, 16, generator=g)
        out = flash_attention(q, q, q, causal=True, device="cpu")
        model = init_lm_params(d_model=16, num_heads=2, num_layers=1,
                               slot_len=12, device="cpu")
        ids = torch.zeros(1, 12, dtype=torch.int32)
        logits = model(ids, torch.arange(12)[None], ids)
        assert torch.isfinite(out).all() and logits.shape == (1, 12, 64)
        for name in petastorm_tpu_torch.__all__:
            getattr(petastorm_tpu_torch, name)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "petastorm_tpu"))
        print("LOADED", loaded)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card behavior")


def _entry_points(tmp_path):
    from petastorm_tpu_torch.models import image_classifier
    from petastorm_tpu_torch.models.long_context_lm import (
        init_lm_params,
        params_from_jax,
        train_lm,
    )
    from petastorm_tpu_torch.models import sequence_model, sequence_training, tabular_dlrm
    from petastorm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_with_lse
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader, make_torch_dataloader
    from petastorm_tpu_torch.torch_utils.packing import make_packed_torch_dataloader
    from petastorm_tpu_torch import pytorch
    from petastorm_tpu_torch.models import mnist
    from petastorm_tpu_torch.reader_impl import pytorch_shuffling_buffer as buffers
    from petastorm_tpu_torch.cache_impl import BatchCache

    q = torch.zeros(1, 8, 2, 16)
    params = {"embed": torch.zeros(64, 16).numpy(), "pos": torch.zeros(8, 16).numpy(),
              "blocks": []}
    return {
        "flash_attention": lambda: flash_attention(q, q, q),
        "make_packed_torch_dataloader": lambda: make_packed_torch_dataloader(
            None, slot_len=8, slots=1, sequence_fields=["tokens"]),
        "TorchDataLoader": lambda: TorchDataLoader(None, lambda: iter(())),
        "train_lm": lambda: train_lm(f"file://{tmp_path}/missing"),
        "init_lm_params": lambda: init_lm_params(),
        "params_from_jax": lambda: params_from_jax(params, num_heads=2),
        "make_torch_dataloader": lambda: make_torch_dataloader(None, 8),
        "make_torch_dataloader_stage_in_producer": lambda: make_torch_dataloader(
            None, 8, stage_in_producer=True),
        "make_torch_dataloader_batch_cache": lambda: make_torch_dataloader(
            None, 8, batch_cache=BatchCache(mem_budget_bytes=1 << 20)),
        "train_image_classifier": lambda: image_classifier.train_image_classifier(
            f"file://{tmp_path}/missing"),
        "init_image_classifier": lambda: image_classifier.init_image_classifier((8, 8, 3), 10),
        "image_params_from_jax": lambda: image_classifier.params_from_jax({}, (8, 8, 3)),
        "flash_attention_with_lse": lambda: flash_attention_with_lse(q, q, q),
        "init_seq_params": lambda: sequence_model.init_seq_params(0, feature_dim=4),
        "seq_params_from_jax": lambda: sequence_model.params_from_jax(
            {name: torch.zeros(4, 4).numpy() for name in sequence_model._SEQ_WEIGHTS},
            num_heads=2),
        "train_sequence": lambda: sequence_training.train_sequence(f"file://{tmp_path}/missing"),
        "train_ragged_causal": lambda: sequence_training.train_ragged_causal(
            f"file://{tmp_path}/missing"),
        "train_packed_causal": lambda: sequence_training.train_packed_causal(
            f"file://{tmp_path}/missing"),
        "init_packed_next_step": lambda: sequence_training.init_packed_next_step(),
        "train_dlrm": lambda: tabular_dlrm.train_dlrm(f"file://{tmp_path}/missing"),
        "init_dlrm": lambda: tabular_dlrm.init_dlrm(),
        "dlrm_params_from_jax": lambda: tabular_dlrm.params_from_jax({}),
        "init_mnist_mlp": lambda: mnist.init_mnist_mlp(),
        "DataLoader": lambda: pytorch.DataLoader(None),
        "BatchedDataLoader": lambda: pytorch.BatchedDataLoader(None),
        "InMemBatchedDataLoader": lambda: pytorch.InMemBatchedDataLoader(None),
        "BatchedNoopShufflingBuffer": lambda: buffers.BatchedNoopShufflingBuffer(),
        "BatchedRandomShufflingBuffer": lambda: buffers.BatchedRandomShufflingBuffer(8),
    }


@pytest.mark.parametrize("entry", ["flash_attention", "make_packed_torch_dataloader",
                                   "TorchDataLoader", "train_lm", "init_lm_params",
                                   "params_from_jax", "make_torch_dataloader",
                                   "train_image_classifier", "init_image_classifier",
                                   "image_params_from_jax", "flash_attention_with_lse",
                                   "init_seq_params", "seq_params_from_jax", "train_sequence",
                                   "train_ragged_causal", "train_packed_causal",
                                   "init_packed_next_step", "train_dlrm", "init_dlrm",
                                   "dlrm_params_from_jax", "init_mnist_mlp", "DataLoader", "BatchedDataLoader",
                                   "InMemBatchedDataLoader", "BatchedNoopShufflingBuffer",
                                   "BatchedRandomShufflingBuffer",
                                   "make_torch_dataloader_stage_in_producer",
                                   "make_torch_dataloader_batch_cache"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path, entry):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points(tmp_path)[entry]()


def test_cuda_tensors_never_take_the_plain_path(no_cuda):
    """A CPU tensor under device='cuda' raises instead of running plain."""
    from petastorm_tpu_torch.ops.flash_attention import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_path_counts_no_launches():
    from petastorm_tpu_torch.ops import flash_attention as fa

    fa.reset_launch_counts()
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 20, 2, 16, generator=g, requires_grad=True)
               for _ in range(3))
    seg = torch.zeros(2, 20, dtype=torch.int32)
    fa.flash_attention(q, k, v, causal=True, segment_ids=seg, device="cpu").sum().backward()
    assert fa.LAUNCHES == {"fwd": 0, "dq": 0, "dkv": 0}
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_device_mismatch_raises():
    from petastorm_tpu_torch.ops.flash_attention import flash_attention

    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="lies on cpu"):
        flash_attention(q, q, q, device="meta")
