"""What the cells run stays what it was: for each cell's configuration, the
seeded weights, the networks' names and shapes, the model FLOPs and the
C-entry calls that one unit needs, pinned at the values the harness gave
before generators were found by family (``reference/nets.py::family``)."""

import hashlib
import json

import pytest
import torch

from portbench import harness, inputs
from portbench.work import calls, model

CELLS = ("voc_dp8_bf16.train", "voc_dp8_bf16.train_dropout", "voc_semisup_256.serve_tta")
SEED = 2 ** 31 + 3
# ResNet-9 (48 leaves) and PatchGAN (10) at ngf = ndf = 64; the same four
# networks in every cell (a serve cell draws all four, keeps G_i2l).
SPEC_SHA = "d804ba41f949bf7063254d2782d5ccae4a6cada5538fe4795572544af9d17f7c"
WEIGHTS_SHA = "048a794447fcafbf35f6095ffb4c640e8d32f131c5602ee2140b737018429545"
TRAIN_FLOPS = 13_522_780_028_928
SERVE_FLOPS = 49_416_819_965_952
TRAIN_CALLS = {"cg_instance_norm_act": [81, 0.0018511572441791064],
               "cg_instance_norm_act_bwd": [81, 0.0024386874841791028],
               "cg_conv3x3_reflect": [54, 0.003517617300060671],
               "cg_conv3x3_reflect_dgrad": [54, 0.003517617300060671],
               "cg_conv_dw": [54, 0.003517617300060671]}
SERVE_CALLS = {"cg_instance_norm_act": [138, 0.02062345536955227],
               "cg_conv3x3_reflect": [108, 0.04080436068070376]}


def cfg_of(name):
    cell = harness.load_cell(name)
    return {**cell.config, **cell.workload.get("config_overrides", {})}, cell.workload["params"]


@pytest.mark.parametrize("cell", CELLS)
def test_specs_pinned(cell):
    specs = inputs.net_specs(cfg_of(cell)[0])
    assert {k: len(v) for k, v in specs.items()} == {"G_i2l": 48, "G_l2i": 48, "D_img": 10,
                                                      "D_lab": 10}
    text = json.dumps({k: [[n, list(s)] for n, s in v] for k, v in specs.items()})
    assert hashlib.sha256(text.encode()).hexdigest() == SPEC_SHA


@pytest.mark.parametrize("cell", CELLS)
def test_weights_pinned(cell):
    w = inputs.make_weights(cfg_of(cell)[0], torch.Generator().manual_seed(SEED))
    h = hashlib.sha256()
    for net in w:
        for name, t in w[net].items():
            h.update(name.encode())
            h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == WEIGHTS_SHA


@pytest.mark.parametrize("cell", CELLS)
def test_flops_and_calls_pinned(cell):
    cfg, p = cfg_of(cell)
    if "serve" in cell:
        assert model.serve_batch_flops(cfg, p) == SERVE_FLOPS
        assert {k: list(v) for k, v in calls.serve_batch_calls(cfg, p).items()} == SERVE_CALLS
    else:
        assert model.train_step_flops(cfg) == TRAIN_FLOPS
        assert {k: list(v) for k, v in calls.train_step_calls(cfg).items()} == TRAIN_CALLS
