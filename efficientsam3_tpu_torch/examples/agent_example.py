"""Segmentation-agent example: an LLM refines the text prompt.

Counterpart of examples/agent_example.py of the JAX package (the
reference's sam3_agent notebook and agent_core.py loop): the MLLM proposes
a noun phrase, EfficientSAM3 grounds it, the detection summary is fed
back, and the loop repeats until the model is satisfied; then a full
tool-call session (segment_phrase / examine_each_mask /
select_masks_and_return over SoM-numbered renders). Without
OPENAI_BASE_URL set, scripted fake LLMs drive both offline. Seeded
weights; the text prompts need ``EFFICIENTSAM3_BPE_PATH``.

    python -m efficientsam3_tpu_torch.examples.agent_example [image.jpg] "<goal>"
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from efficientsam3_tpu_torch.agent import (
    SegmentationAgent,
    agent_inference,
    openai_chat_client,
)
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.processor import Sam3Processor
from efficientsam3_tpu_torch.scripts._common import add_device_flag, load_rgb, model_resolution


def scripted_llm():
    """Offline stand-in: refines 'animal' -> 'dog' -> done."""
    replies = iter(
        [
            json.dumps({"phrase": "animal"}),
            json.dumps({"phrase": "dog"}),
            json.dumps({"done": True}),
        ]
    )

    def call(messages):
        return next(replies)

    return call


def scripted_tool_llm():
    """Offline tool-session driver: segments once, examines each mask
    (accepting all), and returns everything."""
    state = {"n": 0}

    def call(messages):
        if "verification" in messages[0]["content"]:
            return "<verdict>Accept</verdict>"
        state["n"] += 1
        if state["n"] == 1:
            return ('<tool>{"name": "segment_phrase", "parameters": '
                    '{"text_prompt": "dog"}}</tool>')
        texts = [c.get("text", "") for m in messages
                 for c in (m["content"] if isinstance(m["content"], list) else [])
                 if isinstance(c, dict)]
        if any("produced no masks" in t for t in texts):
            return '<tool>{"name": "report_no_mask", "parameters": {}}</tool>'
        if any("segment_phrase produced" in t for t in texts):
            return '<tool>{"name": "examine_each_mask", "parameters": {}}</tool>'
        return ('<tool>{"name": "select_masks_and_return", "parameters": '
                '{"final_answer_masks": [1, 2, 3]}}</tool>')

    return call


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("image", nargs="?", default=None)
    ap.add_argument("goal", nargs="?", default="segment the dog")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.image:
        image = load_rgb(args.image)
    else:
        image = np.random.default_rng(0).integers(0, 255, (480, 640, 3), np.uint8)

    model = build_efficientsam3_image_model(
        backbone_type="efficientvit", model_name="m",
        text_encoder_type="MobileCLIP-S0", text_encoder_context_length=32,
        device=resolve_device(args.device),
    )
    processor = Sam3Processor(model, resolution=model_resolution(model),
                              confidence_threshold=0.3)

    online = bool(os.environ.get("OPENAI_BASE_URL"))
    if online:
        llm = openai_chat_client(
            os.environ["OPENAI_BASE_URL"],
            os.environ.get("OPENAI_API_KEY", ""),
            os.environ.get("OPENAI_MODEL", "gpt-4o"),
        )
    else:
        llm = scripted_llm()

    agent = SegmentationAgent(processor, llm, max_iterations=4)
    result = agent.run(image, args.goal)
    if result is None:
        print("agent found nothing")
    else:
        print(f"best phrase: {result.phrase!r} after {result.iterations} "
              f"iterations, {len(result.scores)} detections")

    messages, final, rendered = agent_inference(
        image, args.goal, llm if online else scripted_tool_llm(), processor=processor,
    )
    print(f"tool session: {len(final['masks'])} final masks")
    try:
        from PIL import Image

        path = os.path.join(tempfile.gettempdir(), "agent_som.png")
        Image.fromarray(rendered).save(path)
        print(f"SoM render saved to {path}")
    except ImportError:
        pass
    return result, final


if __name__ == "__main__":
    main()
