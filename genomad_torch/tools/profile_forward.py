"""Stage-by-stage timing of the IGLOO forward pass on the card.

    python -m genomad_torch.tools.profile_forward [BATCH]

Counterpart of ``tools/profile_forward.py``: times each component of the
full-width bf16 forward in isolation, by CUDA events, to locate the
bottleneck: the full forward, tokenization, conv1 (K5 ``embed_conv``),
conv2 + conv3 (K4 ``causal_conv``), the fused IGLOO kernel (K2
``fused_reduce`` and the attention), the patch reduction alone (K3
``patch_reduce``), the value projection alone (``torch.matmul``) and the
first head dense. Milliseconds per batch; synthetic weights from seed 0.
Not a correctness tool. A measurement: it needs a card and raises without
one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from genomad_torch.device import resolve_device
from genomad_torch.models import igloo
from genomad_torch.ops import conv, patch_reduce

BATCH = 128  # the CLI default


def forward_stages(model: igloo.IglooClassifier, bases: torch.Tensor) -> dict:
    """The stages, each a function of no arguments on ``bases`` (B, 6000)
    on the model's device, in the order they are printed."""
    tokens = igloo._tokens_from_bases(igloo._pad_bases(bases)).contiguous()
    h1 = conv.embed_conv(tokens, model.conv1.kernel, model.conv1.bias)
    ig = model.igloo1
    slots = patch_reduce.SlotTable(ig.slot_index, ig.slot_weights)
    feat = torch.zeros((bases.shape[0], 2 * igloo.CHANNELS), dtype=model.dtype, device=bases.device)
    return {
        "full forward": lambda: model.forward_bases(bases),
        "tokenize": lambda: igloo._tokens_from_bases(igloo._pad_bases(bases)),
        "conv1 (K5 embed_conv)": lambda: conv.embed_conv(tokens, model.conv1.kernel, model.conv1.bias),
        "conv2+conv3 (K4 causal_conv)": lambda: conv.causal_conv(
            conv.causal_conv(h1, model.conv2.kernel, model.conv2.bias), model.conv3.kernel, model.conv3.bias
        ),
        "igloo kernel (K2 fused_reduce + attention)": lambda: model._igloo_kernel(h1, ig),
        "  patch_reduce alone (K3)": lambda: patch_reduce.patch_reduce(h1, ig.patches, ig.w_patch, slots=slots),
        "  value proj alone (torch.matmul)": lambda: torch.matmul(h1, ig.w_v),
        "head dense (first)": lambda: model._dense_bn_relu(feat, model.enc_dense, model.enc_bn),
    }


def profile_forward(batch: int = BATCH, device=None, iters: int = 20, seed: int = 0) -> dict:
    """Milliseconds per batch of each stage (mean over ``iters`` calls after
    two warm-up calls, CUDA events), and the K3 launches the run made."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("profile_forward times the card with CUDA events; it takes a CUDA device")
    rng = np.random.default_rng(seed)
    bases = torch.from_numpy(rng.integers(0, 4, (batch, 6000)).astype(np.uint8)).to(device)
    model = igloo.IglooClassifier(igloo.init_params(seed), device=device)
    launches_before = patch_reduce.patch_reduce.launches
    ms = {}
    with torch.inference_mode():
        for name, fn in forward_stages(model, bases).items():
            for _ in range(2):
                fn()
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            ms[name] = start.elapsed_time(end) / iters
    return {"batch": batch, "ms": ms, "k3_launches": patch_reduce.patch_reduce.launches - launches_before}


def main() -> None:
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else BATCH
    result = profile_forward(batch)
    print(f"# {torch.cuda.get_device_name(0)}, batch {batch}, bf16, ms per batch")
    for name, ms in result["ms"].items():
        print(f"{name:45s} {ms:9.4f} ms", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
