"""The port's agent copy against the JAX package's: the sessions of
tests/test_agent.py and tests/test_agent_tools.py (a scripted LLM and a
fake segmenter, no model, no network) run through both agents, and the
message histories, results, events and rendered arrays must be equal.
Then one ``agent_inference`` session over the port's tiny Sam3Processor
on the CPU."""

import gzip
import importlib
import json

import numpy as np
import pytest

PKGS = ("efficientsam3_tpu", "efficientsam3_tpu_torch")


def agent(pkg):
    return importlib.import_module(f"{pkg}.agent")


def assert_equal_tree(got, want, path="out"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_equal_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


class FakeProcessor:
    """tests/test_agent.py's: only 'a yellow dog' produces detections."""

    def set_image(self, image):
        return {}

    def reset_all_prompts(self, state):
        state.clear()

    def set_text_prompt(self, phrase, state):
        if phrase == "a yellow dog":
            state["scores"] = np.asarray([0.9, 0.7])
            state["masks"] = np.ones((2, 8, 8), bool)
            state["boxes"] = np.zeros((2, 4))
        else:
            state["scores"] = np.zeros(0)
            state["masks"] = np.zeros((0, 8, 8), bool)
            state["boxes"] = np.zeros((0, 4))
        return state


def refine_llm(messages):
    last = messages[-1]["content"]
    if "Goal" in last:
        return json.dumps({"phrase": "dog"})
    if "0 detections" in last:
        return json.dumps({"phrase": "a yellow dog"})
    return json.dumps({"done": True, "best_phrase": "a yellow dog"})


def recorded(llm):
    """llm that keeps a copy of every message list it is shown."""
    seen = []

    def call(messages):
        seen.append([dict(m) for m in messages])
        return llm(messages)

    return call, seen


def run_segmentation_agent(pkg, llm_factory, **kw):
    llm, seen = recorded(llm_factory())
    result = agent(pkg).SegmentationAgent(FakeProcessor(), llm, **kw).run(
        np.zeros((16, 16, 3), np.uint8), "find the yellow dog")
    return {"seen": seen, "result": None if result is None else vars(result)}


def numbered_llm():
    calls = []

    def llm(messages):
        calls.append(len(messages))
        return json.dumps({"phrase": f"thing {len(calls)}"})

    return llm


def _scene():
    img = np.full((96, 128, 3), 40, np.uint8)
    m1 = np.zeros((96, 128), bool)
    m1[10:30, 10:40] = True
    m2 = np.zeros((96, 128), bool)
    m2[50:90, 60:120] = True
    return img, [m1, m2], [[10, 10, 40, 30], [60, 50, 120, 90]]


class ScriptedLLM:
    """tests/test_agent_tools.py's: segment 'animal' (empty) -> segment
    'dog' (2 masks) -> examine (accept #1, reject #2) -> select [1, 7]."""

    def __init__(self):
        self.n_checks = 0

    def __call__(self, messages):
        if "verification" in messages[0]["content"]:
            self.n_checks += 1
            return "<verdict>Accept</verdict>" if self.n_checks == 1 else "<verdict>Reject</verdict>"
        texts = [c["text"] for m in messages if isinstance(m.get("content"), list)
                 for c in m["content"] if isinstance(c, dict) and c.get("type") == "text"]
        state = texts[-1] if texts else ""
        if "user query is" in state:
            return '<tool>{"name": "segment_phrase", "parameters": {"text_prompt": "animal"}}</tool>'
        if "produced no masks" in state:
            return '<tool>{"name": "segment_phrase", "parameters": {"text_prompt": "dog"}}</tool>'
        if "segment_phrase produced" in state:
            return '<tool>{"name": "examine_each_mask", "parameters": {}}</tool>'
        if "remain" in state:
            return ('<tool>{"name": "select_masks_and_return", "parameters": '
                    '{"final_answer_masks": [1, 7]}}</tool> trailing words')
        raise AssertionError(f"unexpected state: {state[:100]}")


def segment_fn(phrase):
    _, masks, boxes = _scene()
    if phrase == "dog":
        return {"scores": np.asarray([0.9, 0.4]), "masks": np.stack(masks),
                "boxes": np.asarray(boxes, np.float32)}
    return {"scores": np.zeros(0), "masks": np.zeros((0, 96, 128), bool),
            "boxes": np.zeros((0, 4))}


def run_tool_session(pkg, llm_factory):
    img, _, _ = _scene()
    llm, seen = recorded(llm_factory())
    events = []
    messages, final, rendered = agent(pkg).agent_inference(
        img, "the sleeping dog", llm, segment=segment_fn, on_event=events.append)
    return {"seen": seen, "messages": messages, "final": final, "rendered": rendered,
            "events": events}


def run_helpers(pkg):
    a = agent(pkg)
    som = importlib.import_module(f"{pkg}.agent.som")
    img, masks, boxes = _scene()
    region = np.zeros((20, 20, 3), np.uint8)
    region[..., 0] = 255
    res = {"image": img, "masks": masks, "boxes": boxes, "scores": [0.9, 0.8]}
    single, zoomed = a.visualize(res, zoom_in_index=1)
    zoom_out, color_hex = a.render_zoom_in(img, masks[0], boxes[0])
    return {
        "overlay": a.overlay_instances(img, masks, boxes),
        "number": som.draw_number(np.zeros((32, 32, 3), np.uint8), 12, (30, 30), (255, 255, 0),
                                  scale=2),
        "farthest": list(a.ColorPalette.default().find_farthest_color(region)),
        "zoom_boxes": [list(map(float, b)) for b in a.compute_zoom_boxes(
            [120, 80, 40, 30], 200, 300, mask_area=40 * 30 * 0.8)],
        "zoom_in": [zoom_out, color_hex],
        "visualize": [a.visualize(res), single, zoomed, a.visualize(res, mask_alpha=0.6)],
        "tool": a.parse_tool_call('x <tool>{"name": "segment_phrase", "parameters": '
                                  '{"text_prompt": "dog"}}}</tool> y'),
        "prompts": [a.GROUNDING_SYSTEM_PROMPT, a.CHECKING_SYSTEM_PROMPT],
    }


SESSIONS = {
    "refine": lambda pkg: run_segmentation_agent(pkg, lambda: refine_llm, max_iterations=5),
    "prune": lambda pkg: run_segmentation_agent(pkg, numbered_llm, max_iterations=10,
                                                history_window=4),
    "tools": lambda pkg: run_tool_session(pkg, ScriptedLLM),
    "no_mask": lambda pkg: run_tool_session(
        pkg, lambda: lambda m: '<tool>{"name": "report_no_mask", "parameters": {}}</tool>'),
    "helpers": run_helpers,
}


@pytest.mark.parametrize("session", sorted(SESSIONS))
def test_agent_copy_matches_jax(session):
    want = SESSIONS[session]("efficientsam3_tpu")
    got = SESSIONS[session]("efficientsam3_tpu_torch")
    assert_equal_tree(got, want)
    if session == "tools":  # the session went where tests/test_agent_tools.py says
        assert len(got["final"]["masks"]) == 1 and got["final"]["scores"] == [0.9]
    if session == "refine":
        assert got["result"]["phrase"] == "a yellow dog"


@pytest.mark.parametrize("pkg", PKGS)
def test_agent_bad_first_tool_raises(pkg):
    a = agent(pkg)
    with pytest.raises(a.ToolCallError, match="first tool"):
        a.agent_inference(_scene()[0], "x", lambda m: (
            '<tool>{"name": "examine_each_mask", "parameters": {}}</tool>'), segment=segment_fn)
    with pytest.raises(a.ToolCallError):
        a.parse_tool_call("no tool here")


def test_agent_inference_over_the_tiny_processor(tmp_path):
    """The tool loop over the port's Sam3Processor (tiny config, seeded
    weights, a stub merge table for the tokenizer): segment a phrase, select
    two masks; the masks come at the image's size."""
    import torch

    from efficientsam3_tpu_torch.agent import agent_inference
    from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
    from efficientsam3_tpu_torch.processor import Sam3Processor

    bpe = tmp_path / "vocab.txt.gz"
    with gzip.open(bpe, "wt") as f:
        f.write("#version\na b\n")
    torch.manual_seed(0)
    model = build_efficientsam3_image_model(
        model_name="b0", embed_size=8, text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=16, device="cpu", fusion_layers=2, decoder_layers=2)
    proc = Sam3Processor(model, resolution=64, confidence_threshold=0.0, bpe_path=str(bpe),
                         context_length=16)
    img = np.random.default_rng(8).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    grounds = []
    ground = model.ground

    def counted(*a, **kw):
        grounds.append(1)
        return ground(*a, **kw)

    model.ground = counted

    def llm(messages):
        texts = [c["text"] for m in messages if isinstance(m.get("content"), list)
                 for c in m["content"] if isinstance(c, dict) and c.get("type") == "text"]
        if "user query is" in texts[-1]:
            return '<tool>{"name": "segment_phrase", "parameters": {"text_prompt": "a ball"}}</tool>'
        assert "segment_phrase produced 200 masks" in texts[-1], texts[-1]
        return ('<tool>{"name": "select_masks_and_return", "parameters": '
                '{"final_answer_masks": [2, 1]}}</tool>')

    messages, final, rendered = agent_inference(img, "the ball", llm, processor=proc)
    assert len(grounds) == 1
    assert len(final["masks"]) == 2 and final["masks"][0].shape == (40, 56)
    assert rendered.shape == img.shape and rendered.dtype == np.uint8
    assert not np.array_equal(rendered, img) or not any(m.any() for m in final["masks"])
    assert len(messages) == 5  # system, query, segment, its result, select
