"""K4's kernel file records every call of the towers while it is installed,
and the towers still run through it: the entries patch the towers' own
look-ups, so the kernel's wrapper keeps its launch counter."""

import torch

from benchmark.counts import roofline
from benchmark.harness import BENCH_DIR, kernel_table
from benchmark.instrument import KernelCalls

from attwarp_tpu_torch.kernels import attn_softmax
from attwarp_tpu_torch.models import clip_vit, qwen2vl


def test_k4_records_each_towers_calls_and_gives_its_least_time():
    g = torch.Generator().manual_seed(0)
    qcfg = qwen2vl.Qwen2VLVisionConfig(depth=2, embed_dim=32, hidden_size=64, num_heads=2,
                                       mlp_ratio=2)
    cfg = qwen2vl.Qwen2VLConfig(vision=qcfg, text=qwen2vl.Qwen2VLTextConfig(
        vocab_size=32, hidden_size=64, intermediate_size=64, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1))
    qparams = qwen2vl.random_params(cfg, g, "cpu", torch.float32)["vision"]
    patches = torch.randn((3, 16, 3 * 2 * 14 * 14), generator=g)
    ccfg = clip_vit.SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                       num_hidden_layers=3, num_attention_heads=2,
                                       image_size=42, patch_size=14)
    lin = {"weight": torch.randn((32, 32), generator=g) * 0.02, "bias": torch.zeros(32)}
    ln = {"weight": torch.ones(32), "bias": torch.zeros(32)}
    cparams = {"patch_weight": torch.randn((32, 14 * 14 * 3), generator=g) * 0.02,
               "patch_bias": torch.zeros(32), "position_embedding": torch.zeros(9, 32),
               "layers": [{"layer_norm1": ln, "layer_norm2": ln, "q_proj": lin, "k_proj": lin,
                           "v_proj": lin, "out_proj": lin,
                           "fc1": {"weight": torch.randn((64, 32), generator=g) * 0.02,
                                   "bias": torch.zeros(64)},
                           "fc2": {"weight": torch.randn((32, 64), generator=g) * 0.02,
                                   "bias": torch.zeros(32)}} for _ in range(3)]}
    pixels = torch.randn((2, 42, 42, 3), generator=g)

    calls = KernelCalls(kernel_table(BENCH_DIR / "kernels"))
    with calls.installed():
        # the wrapper's own name is left alone: it counts its launches on it
        assert not hasattr(attn_softmax.scaled_softmax_, "__wrapped__")
        assert hasattr(qwen2vl.scaled_softmax_, "__wrapped__")
        calls.start()
        qwen2vl.qwen2vl_vision_features(qparams, qcfg, patches, (4, 4))
        clip_vit.clip_vision_features(cparams, ccfg, pixels, feature_layer=-1)
        calls.stop()
    # Qwen2-VL: a call a block and image, (heads, 16, 16); SigLIP: a call a
    # block, (2, heads, 9, 9)
    assert calls.calls["k4"] == [(2 * 16, 16, 4)] * (2 * 3) + [(2 * 2 * 9, 9, 4)] * 3
    want = (6 * roofline.bound(2 * 4 * 32 * 16, 5 * 32 * 16)["bound_ms"]
            + 3 * roofline.bound(2 * 4 * 36 * 9, 5 * 36 * 9)["bound_ms"]) / 1e3
    assert abs(calls.least_seconds()["k4"] - want) <= 1e-12 * want
