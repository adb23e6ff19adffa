"""The cells at a size a CPU test holds: ngf 8, 32x32, 2 trunk blocks,
float32, 2 rows (train) or 2 canvases of 64x64 a call (serve)."""

TRAIN = {"config": {"gen_net": "resnet_2blocks", "ngf": 8, "ndf": 8, "crop_height": 32,
                    "crop_width": 32, "bf16": False, "batch_size": 2, "pool_size": 3},
         "params": {"ring": 3, "image_cell": 8, "label_cell": 8, "host_probes": 2,
                    "trace_steps": 2}}
SERVE = {"config": {"gen_net": "resnet_2blocks", "ngf": 8, "crop_height": 32, "crop_width": 32,
                    "bf16": False},
         "params": {"ring": 4, "canvas_hw": [64, 64], "image_cell": 8, "images_per_call": 2,
                    "check_answers": 3, "host_probes": 1, "trace_batches": 2,
                    "calib_batches": 2}}
# The served logits' scale grows with the head's fan-in (ngf x 49): the
# control of the serve cell is held at the published ngf of 64.
SERVE_WIDE = {"config": {**SERVE["config"], "ngf": 64}, "params": SERVE["params"]}
TRAIN_CELLS = ("voc_dp8_bf16.train", "voc_dp8_bf16.train_dropout")
SERVE_CELLS = ("voc_semisup_256.serve_tta",)


def overrides(cell: str) -> dict:
    return SERVE if cell in SERVE_CELLS else TRAIN
# The U-Net family through a train cell's overrides: unet_128 at ngf 4,
# 128x128 (its 7 levels down to 1x1), 2 rows, float32.
UNET = {"config": {**TRAIN["config"], "gen_net": "unet_128", "ngf": 4, "crop_height": 128,
                   "crop_width": 128},
        "params": {**TRAIN["params"], "image_cell": 16, "label_cell": 16}}
