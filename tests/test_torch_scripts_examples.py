"""Each of the port's examples runs once on the CPU through its
``main(argv)``, at the tiny config (the builders replaced in the example's
namespace: b0 at 112², embed 8, MobileCLIP-S0 at context 16, one fusion
and one decoder layer; a b0 SAM1 student at 128²), with text prompts
tokenised through the synthetic byte-level BPE file."""

import pytest

import _torch_threads  # noqa: F401

from efficientsam3_tpu_torch.build import (
    build_efficientsam3_image_model,
    build_efficientsam3_video_model,
    init_parameters,
    make_trunk,
)
from efficientsam3_tpu_torch.examples import (
    agent_example,
    batch_processor_example,
    edge_sam_example,
    image_predictor_example,
    sam1_task_example,
    video_pcs_example,
    video_tracking_example,
)
from efficientsam3_tpu_torch.scripts import _common
from efficientsam3_tpu_torch.student_sam import SamStudentModel


def tiny_image_model(*, dtype=None, device=None, **kw):
    kw = dict(kw, model_name="b0", embed_size=8, text_encoder_context_length=16)
    return build_efficientsam3_image_model(**kw, device="cpu", fusion_layers=1,
                                           decoder_layers=1)


def tiny_video_model(*, dtype=None, device=None, **kw):
    kw = dict(kw, backbone_type="efficientvit", model_name="b0", embed_size=8,
              text_encoder_context_length=16)
    return build_efficientsam3_video_model(**kw, device="cpu")


@pytest.fixture(autouse=True)
def bpe(tmp_path, monkeypatch):
    monkeypatch.setenv("EFFICIENTSAM3_BPE_PATH",
                       _common.write_byte_level_bpe(str(tmp_path / "bpe.txt.gz")))


@pytest.mark.parametrize("example", [image_predictor_example, batch_processor_example])
def test_image_examples(example, monkeypatch):
    monkeypatch.setattr(example, "build_efficientsam3_image_model", tiny_image_model)
    state = example.main(["--device", "cpu"])
    if example is image_predictor_example:
        assert state["masks"].shape[1:] == (480, 640)
    else:
        assert state["batch_size"] == 4 and len(state["masks"]) == 4


def test_agent_example(monkeypatch, tmp_path):
    monkeypatch.setattr(agent_example, "build_efficientsam3_image_model", tiny_image_model)
    monkeypatch.delenv("OPENAI_BASE_URL", raising=False)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    result, final = agent_example.main(["--device", "cpu"])
    assert isinstance(final["masks"], list)
    assert (tmp_path / "agent_som.png").exists()


def test_edge_sam_example(monkeypatch):
    def student(device=None, seed=0):
        model = SamStudentModel(make_trunk("efficientvit", "b0"), image_size=128, embed_size=8)
        return init_parameters(model, seed).requires_grad_(False).eval()

    monkeypatch.setitem(edge_sam_example.sam_model_registry, "efficientvit", student)
    masks, box_mask = edge_sam_example.main(["--device", "cpu"])
    assert masks.shape[-2:] == (480, 640) and box_mask.shape[-2:] == (480, 640)


def test_sam1_task_example(monkeypatch):
    monkeypatch.setattr(sam1_task_example, "build_efficientsam3_video_model", tiny_video_model)
    masks, masks_b, anns = sam1_task_example.main(["--device", "cpu"])
    assert masks.shape[-2:] == (480, 640) and masks_b.shape[-2:] == (480, 640)
    assert isinstance(anns, list)


def test_video_tracking_example(monkeypatch):
    monkeypatch.setattr(video_tracking_example, "build_efficientsam3_video_model",
                        tiny_video_model)
    out = video_tracking_example.main(["--device", "cpu"])
    assert [t for t, _, _ in out] == [0, 1, 2, 3] and all(ids == [1] for _, ids, _ in out)


def test_video_pcs_example(monkeypatch, tmp_path):
    monkeypatch.setattr(video_pcs_example, "build_efficientsam3_video_model", tiny_video_model)
    _common.write_video_fixture(str(tmp_path / "video"), frames=3, size=112, mask_side=32)
    out = video_pcs_example.main([str(tmp_path / "video" / "frames"), "a red square",
                                  "--device", "cpu"])
    assert len(out) == 3 and all("obj_ids" in o for o in out)
