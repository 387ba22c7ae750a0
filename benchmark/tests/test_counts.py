"""The benchmark's yardstick: its copy of the roofline counts equals the
program's at the shapes of PERF.md's kernel table, the model-FLOP count of
a tiny configuration equals a count by hand, and the counts that moved into
the family and kernel files give what the harness's own functions gave
before they moved (the literals below)."""

import pytest
import torch

from attwarp_tpu_torch.kernels import roofline as program
from benchmark.counts import model_flops, roofline as copy
from benchmark.harness import BENCH_DIR, cell_parts, kernel_table, make_driver
from benchmark.instrument import KernelCalls
from benchmark.tests.rehearse import MINI_CELLS, mini_bench, mini_dir

# PERF.md's kernel table: (kernel, args)
K1 = [(4, 512, 640, 3, 500, 500), (2, 512, 640, 3, 500, 500), (1, 512, 512, 3, 500, 500),
      (1, 1024, 683, 3, 500, 500), (128, 336, 336, 3, 336, 336), (10, 512, 512, 3, 500, 500),
      (128, 512, 512, 3, 512, 512)]
K2 = [(4, 640, 32, 32, [10, 0, 40, 25]), (4, 640, 28, 4, [0, 3, 60, 12]),
      (8, 704, 32, 32, [64] * 8), (8, 640, 32, 32, list(range(0, 64, 8))),
      (1, 640, 32, 32, [17]), (8, 704, 28, 4, [5] * 8), (4, 640, 16, 16, [1, 2, 3, 4]),
      (4, 640, 14, 2, [0, 0, 0, 0])]
K3 = [(4, 704, 32, 32, 2700), (4, 704, 28, 4, 2600), (16, 768, 32, 32, 10000),
      (8, 768, 32, 32, 5000), (8, 704, 32, 32, 5200), (8, 704, 32, 32, 4900),
      (8, 768, 28, 4, 5100), (4, 704, 16, 16, 2700), (4, 704, 14, 2, 2650)]
BWD = [(4, 512, 640, 3, 500, 500, True, True), (10, 512, 512, 3, 512, 512, False, True),
       (16, 512, 512, 3, 512, 512, False, True), (1, 1024, 683, 3, 500, 500, True, False)]


@pytest.mark.parametrize("args", K1)
def test_k1_work_equals_the_programs(args):
    assert copy.k1_work(*args) == program.k1_work(*args)
    nb, fl = copy.k1_work(*args)
    assert copy.bound(nb, fl) == program.bound(nb, fl)


@pytest.mark.parametrize("args", K2)
def test_k2_work_equals_the_programs(args):
    assert copy.k2_work(*args) == program.k2_work(*args)
    nb, fl = copy.k2_work(*args)
    assert copy.bound(nb, fl) == program.bound(nb, fl)


@pytest.mark.parametrize("args", K3)
def test_k3_work_equals_the_programs(args):
    assert copy.k3_work(*args) == program.k3_work(*args)
    nb, fl = copy.k3_work(*args)
    assert copy.bound(nb, fl) == program.bound(nb, fl)


@pytest.mark.parametrize("args", BWD)
def test_k1_backward_and_w8a8_work_equal_the_programs(args):
    assert copy.k1_backward_work(*args) == program.k1_backward_work(*args)
    assert copy.w8a8_work(16, 4096, 11008) == program.w8a8_work(16, 4096, 11008)


def test_decoder_flops_of_a_tiny_config_by_hand():
    # D=8, H=2 heads of 4, one kv head, FFN 16, vocab 10, 2 layers
    d = model_flops.DecoderDims(hidden=8, heads=2, kv_heads=1, head_dim=4, ffn=16, vocab=10,
                                layers=2)
    # a token in a layer: q 8x8, k and v 8x4 each, o 8x8, gate/up/down 8x16 each
    per_token = 2 * (64 + 32 + 32 + 64 + 3 * 128)
    assert d.token_layer_flops() == per_token == 1152
    # 3 prompt tokens and 2 fed back: 5 tokens, causal pairs 1+2+3+4+5 = 15,
    # 4 flops x head_dim x heads a pair; LM head at 3 positions (2 x 8 x 10)
    want = 2 * (5 * 1152 + 15 * 4 * 4 * 2) + 3 * 160
    assert model_flops.decoder_flops(d, 3, 2, 3) == want
    # one more token through the first layer only: 1152 + 6 pairs x 32
    assert model_flops.decoder_flops(d, 3, 2, 3, n_partial=1, partial_layers=1) == \
        want + 1152 + 6 * 32


def test_vision_flops_of_tiny_towers_by_hand():
    # CLIP: 28 px, patch 14 -> 4 patches + class token; width 8, FFN 16, 1 layer
    embed = 2 * 4 * (14 * 14 * 3) * 8
    block = 2 * 5 * (4 * 64 + 2 * 8 * 16) + 4 * 25 * 8
    proj = 2 * 4 * (8 * 6 + 36)
    assert model_flops.clip_tower_flops(8, 16, 28, 14, 1, 6) == embed + block + proj
    # Qwen2-VL: 56 px, patch 14 -> 16 patches, merge 2 -> 4 tokens; width 8,
    # FFN 16, one block, text width 6
    embed = 2 * 16 * (3 * 2 * 196) * 8
    block = 2 * 16 * (4 * 64 + 2 * 8 * 16) + 4 * 256 * 8
    merger = 2 * 4 * (32 * 32 + 32 * 6)
    assert model_flops.qwen2vl_vision_flops(8, 2, 1, 56, 14, 2, 2, 6) == embed + block + merger


# ``KernelCalls.least_seconds`` at each shape above, and the ``model_flops``
# counter of each rehearsal cell's first two batches (seed 2**31 + 7), as the
# harness gave them while the kernels and the FLOP counts were tables of its
# own
LEAST_S = {
    "k1": [8.281982089552239e-06, 4.140991044776119e-06, 1.8357397014925374e-06,
           3.402001194029851e-06, 0.00010363002268656717, 1.8357397014925374e-05,
           0.00024054646447761193],
    "k2": [2.5041385074626865e-05, 1.2521074626865672e-05, 5.50910471641791e-05,
           5.008277014925373e-05, 6.260346268656716e-06, 2.83722340950455e-05,
           1.2521074626865672e-05, 6.260919402985074e-06],
    "k3": [6.829239402985075e-06, 8.375402985074627e-07, 2.5299830447761193e-05,
           1.2649915223880596e-05, 1.3154120597014925e-05, 1.2397583283582089e-05,
           1.6437110447761194e-06, 3.41504e-06, 4.270710447761194e-07],
}
MODEL_FLOPS = {"mini.twopass": 5226795008.0, "miniq.twopass": 4285071360.0,
               "mini.serve": 2801130496.0}

META = "meta"


def k1_args(B, H, W, C, H_out, W_out):
    return (torch.empty(B, H, W, C, device=META), torch.empty(B, W_out, device=META),
            torch.empty(B, H_out, device=META))


def k2_args(B, T, H, kvH, pads):
    mask = torch.zeros(B, T, dtype=torch.bool)
    for b, p in enumerate(pads):
        mask[b, p:] = True
    qkv = [torch.empty(B, T, h, 128, device=META) for h in (H, kvH, kvH)]
    return (*qkv, mask)


def k3_args(B, S, H, kvH, n_valid):
    mask = torch.zeros(B * S, dtype=torch.bool)
    mask[:n_valid] = True
    cache = torch.empty(2, B, S, kvH, 128, dtype=torch.int8, device=META)
    return (torch.empty(B, H, 128, device=META), cache, None, cache, None, mask.view(B, S))


ARGS = {"k1": (K1, k1_args), "k2": (K2, k2_args), "k3": (K3, k3_args)}


@pytest.mark.parametrize("kernel,i", [(k, i) for k, (shapes, _) in ARGS.items()
                                      for i in range(len(shapes))])
def test_least_seconds_through_the_kernel_files_is_the_harness_tables(kernel, i):
    """A call recorded through the kernel's file (its argument shapes at
    the Python entry, the mask reduced) gives the least time the harness's
    table gave."""
    shapes, make = ARGS[kernel]
    calls = KernelCalls(kernel_table(BENCH_DIR / "kernels"))
    calls.start()
    calls.wrapper(kernel)(lambda *a, **k: None)(*make(*shapes[i]))
    assert calls.least_seconds() == {kernel: LEAST_S[kernel][i]}


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return mini_dir(tmp_path_factory.mktemp("counts"))


@pytest.mark.parametrize("cell", sorted(MINI_CELLS))
def test_model_flops_counter_of_each_rehearsal_cell_is_the_harness_tables(cell, mini):
    """The family's ``image_flops`` and ``request_flops`` give the counter
    the harness's own ``vision_flops`` and ``decoder_dims`` gave, bit for
    bit."""
    _cell, c, m = cell_parts(mini_bench(), cell, mini)
    torch.manual_seed(0)
    driver = make_driver(c, m, 2**31 + 7, torch.device("cpu"), mini)
    driver.step(0)
    driver.step(1)
    assert driver.counters(driver.records)["model_flops"] == MODEL_FLOPS[cell]
