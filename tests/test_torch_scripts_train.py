"""The port's training and checkpoint entry points on the CPU at the tiny
config, each ``main(argv)`` called in-process with the model builders
replaced in the script's namespace (b0, embed 8, 112², MobileCLIP-S0 at
context 16, one fusion and one decoder layer, dropout off; a 2-block
ViT teacher of width 32):

  - train_stage3: 2 steps, then a resumed run for the third, against 3
    steps without a break on the shapes fixture as a COCO source: the
    third step's loss equal (the batch of step s is drawn from (0, s), and
    the partial checkpoint carries the trunk, the text tower, every
    BatchNorm statistic and the optimizer);
  - verify_checkpoint: exit 0 on a good checkpoint (and with an extra key
    unless ``--strict``), 1 on a NaN, a wrong shape, a missing key or a
    reference .pt the converters cannot read;
  - save_embedding_image_stage1 (seeded, and from the same weights in a
    SAM3 checkpoint's layout: the same records) then ``--check-saved-embed`` (the records
    within a bf16 ulp and fp16 rounding of a fresh pass of the bf16
    teacher at another batch size), and train_image_encoder_stage1
    on that store with a resume.
"""

import functools
import json

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

from efficientsam3_tpu_torch.build import build_efficientsam3_image_model, init_parameters
from efficientsam3_tpu_torch.models.vitdet import ViTTrunk
from efficientsam3_tpu_torch.scripts import _common
from efficientsam3_tpu_torch.scripts import save_embedding_image_stage1 as save_embed
from efficientsam3_tpu_torch.scripts import train_image_encoder_stage1 as stage1
from efficientsam3_tpu_torch.scripts import train_stage3, verify_checkpoint
from efficientsam3_tpu_torch.train.stage1 import Stage1ImageConfig
from efficientsam3_tpu_torch.utils.checkpoint import latest_step, model_state, save_checkpoint

CTX = 16


def tiny_image_model(*, dtype=None, device=None, **kw):
    kw = dict(kw, model_name="b0", embed_size=8, text_encoder_context_length=CTX)
    return build_efficientsam3_image_model(**kw, device="cpu", fusion_layers=1,
                                           decoder_layers=1, dropout=0.0)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return _common.write_shapes_coco(str(tmp_path_factory.mktemp("coco")), num_images=3,
                                     size=112)


def test_train_stage3_resume_matches_an_unbroken_run(coco, tmp_path, monkeypatch):
    bpe = _common.write_byte_level_bpe(str(tmp_path / "bpe.txt.gz"))
    monkeypatch.setenv("EFFICIENTSAM3_BPE_PATH", bpe)
    monkeypatch.setattr(train_stage3, "build_efficientsam3_image_model", tiny_image_model)
    losses = []

    def step(model, opt, batch, **kw):
        m = train_stage3.stage3_train_step.__wrapped__(model, opt, batch, **kw)
        losses.append(float(m["loss"]))
        return m

    step.__wrapped__ = train_stage3.stage3_train_step
    monkeypatch.setattr(train_stage3, "stage3_train_step", step)
    sources = tmp_path / "sources.json"
    sources.write_text(json.dumps([{"name": "shapes", "ann": coco,
                                    "image_root": coco.rsplit("/", 1)[0]}]))

    def run(ckpt, steps):
        return train_stage3.main(["--sources", str(sources), "--max-steps", str(steps),
                                  "--checkpoint-dir", str(ckpt), "--batch-size", "1",
                                  "--context-length", str(CTX), "--no-augment",
                                  "--device", "cpu"])

    assert run(tmp_path / "a", 3) == 3
    unbroken = list(losses)
    losses.clear()
    assert run(tmp_path / "b", 2) == 2 and latest_step(str(tmp_path / "b")) == 2
    assert losses == unbroken[:2]
    assert run(tmp_path / "b", 3) == 3
    assert losses[2:] == unbroken[2:]  # the resumed third step
    state = torch.load(tmp_path / "b" / "step_3" / "state.pt", weights_only=True)
    assert {k.split(".")[0] for k in state["params"]} == {"trunk", "text_encoder"}


@pytest.fixture(scope="module")
def verify_model():
    return tiny_image_model()


@pytest.mark.parametrize("case,code", [("good", 0), ("extra", 0), ("extra-strict", 1),
                                       ("nan", 1), ("shape", 1), ("missing", 1),
                                       ("torch-pt", 0), ("reference-pt", 1)])
def test_verify_checkpoint_exit_codes(case, code, verify_model, tmp_path, monkeypatch):
    monkeypatch.setattr(verify_checkpoint, "build_efficientsam3_image_model",
                        lambda **kw: verify_model)
    state = model_state(verify_model)
    params = dict(state["params"])
    name = next(k for k in params if k.startswith("trunk"))
    if case.startswith("extra"):
        params["trunk.extra"] = torch.zeros(2)
    elif case == "nan":
        params[name] = params[name].clone()
        params[name].view(-1)[0] = float("nan")
    elif case == "shape":
        params[name] = torch.zeros(3, *params[name].shape[1:])
    elif case == "missing":
        del params[name]
    argv = ["--device", "cpu", "--context-length", str(CTX), "--model-name", "b0"]
    if case == "torch-pt":
        torch.save(params, tmp_path / "sd.pt")
        argv += ["--torch-pt", str(tmp_path / "sd.pt")]
    elif case == "reference-pt":
        torch.save({"detector.backbone.x": torch.zeros(1)}, tmp_path / "ref.pt")
        argv += ["--torch-pt", str(tmp_path / "ref.pt")]
    else:
        save_checkpoint(str(tmp_path), 7, dict(state, params=params))
        argv += ["--ckpt-dir", str(tmp_path)]
    if case == "extra-strict":
        argv.append("--strict")
    assert verify_checkpoint.main(argv) == code


def test_stage1_export_check_and_train(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    images = tmp_path / "images"
    images.mkdir()
    for i in range(4):  # non-square: the records' valid masks cut the padding
        _common.save_rgb(str(images / f"{i}.png"),
                         rng.integers(0, 255, (90 + 6 * i, 112, 3), np.uint8))
    tiny_vit = functools.partial(ViTTrunk, embed_dim=32, depth=2, num_heads=2, window_size=4,
                                 global_att_blocks=(1,))
    monkeypatch.setattr(save_embed, "ViTTrunk", tiny_vit)
    store = str(tmp_path / "embeds.bin")
    common = ["--images-dir", str(images), "--store", store, "--image-size", "112",
              "--device", "cpu"]
    assert save_embed.main(common + ["--batch-size", "3"]) == 4
    # --teacher-checkpoint: the seeded teacher's weights in a SAM3 .pt's
    # layout (load_reference_checkpoint(part="vitdet")) export the same records
    ref = {}
    for k, v in init_parameters(tiny_vit(dtype=torch.bfloat16), 0).state_dict().items():
        k = k.replace("patch_embed.weight", "patch_embed.proj.weight").replace("mlp_fc", "mlp.fc")
        v = v.float()  # a released checkpoint holds fp32
        ref[f"detector.backbone.vision_backbone.trunk.{k}"] = v[None] if k == "pos_embed" else v
    torch.save(ref, tmp_path / "sam3.pt")
    store2 = str(tmp_path / "embeds_ckpt.bin")
    assert save_embed.main(["--images-dir", str(images), "--store", store2, "--image-size", "112",
                            "--device", "cpu", "--batch-size", "3", "--teacher-checkpoint",
                            str(tmp_path / "sam3.pt")]) == 4
    assert open(store, "rb").read() == open(store2, "rb").read()

    err, mag = save_embed.main(common + ["--check-saved-embed"])
    # the teacher computes in bf16: a fresh pass at another batch size may
    # round a value the other way, one bf16 ulp (2^-7 relative), and the
    # record's fp16 adds 2^-11
    assert 0.0 < mag and err <= (2.0 ** -7 + 2.0 ** -11) * mag

    monkeypatch.setattr(stage1, "Stage1ImageConfig",
                        functools.partial(Stage1ImageConfig, embed_dim=32))
    argv = ["--images-dir", str(images), "--store", store, "--image-size", "112",
            "--model", "b0", "--batch-size", "2", "--epochs", "1",
            "--checkpoint-dir", str(tmp_path / "ckpt"), "--device", "cpu"]
    assert stage1.main(argv) == 2
    assert latest_step(str(tmp_path / "ckpt")) == 2
    assert stage1.main(argv) == 2  # resumed at the end: no step left
