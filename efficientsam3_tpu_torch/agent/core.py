"""Copy of efficientsam3_tpu/agent/core.py.

Agent: MLLM-orchestrated promptable segmentation.

Mirrors the reference agent (sam3/sam3/agent/agent_core.py, client_llm.py,
client_sam3.py): an LLM iteratively proposes noun-phrase prompts for a
target description, inspects the segmentation results, and refines the
phrase until the detections satisfy it (or the iteration budget runs out).
Message history is pruned to a fixed window (agent_core.py:58).

The LLM is dependency-injected: any callable(messages) -> str works — an
OpenAI-compatible client (`openai_chat_client`) or a local stub in tests.
The segmentation backend is any Sam3Processor-compatible object.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Optional

import numpy as np

SYSTEM_PROMPT = (
    "You control a promptable segmentation model. Given a user goal, reply "
    "with a JSON object {\"phrase\": <short noun phrase to segment>} or "
    "{\"done\": true, \"best_phrase\": <phrase>} when the results look right. "
    "You will be shown the number of detections and their scores after each try."
)


def openai_chat_client(base_url: str, api_key: str, model: str) -> Callable:
    """OpenAI-compatible chat client (reference client_llm.py:34)."""

    def call(messages):
        import json as _json
        import urllib.request

        req = urllib.request.Request(
            f"{base_url.rstrip('/')}/chat/completions",
            data=_json.dumps({"model": model, "messages": messages}).encode(),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {api_key}",
            },
        )
        with urllib.request.urlopen(req) as r:
            out = _json.loads(r.read())
        return out["choices"][0]["message"]["content"]

    return call


@dataclasses.dataclass
class AgentResult:
    phrase: str
    scores: np.ndarray
    masks: np.ndarray
    boxes: np.ndarray
    iterations: int


class SegmentationAgent:
    def __init__(
        self,
        processor,  # Sam3Processor
        llm: Callable,  # callable(messages) -> str
        max_iterations: int = 5,
        history_window: int = 12,
    ):
        self.processor = processor
        self.llm = llm
        self.max_iterations = max_iterations
        self.history_window = history_window

    def _prune(self, messages: list) -> list:
        """Keep the system prompt + the most recent window (agent_core.py:58)."""
        if len(messages) <= self.history_window:
            return messages
        return [messages[0]] + messages[-(self.history_window - 1) :]

    def run(self, image: np.ndarray, goal: str) -> Optional[AgentResult]:
        state = self.processor.set_image(image)
        messages = [
            {"role": "system", "content": SYSTEM_PROMPT},
            {"role": "user", "content": f"Goal: {goal}"},
        ]
        best = None
        for it in range(self.max_iterations):
            reply = self.llm(self._prune(messages))
            messages.append({"role": "assistant", "content": reply})
            try:
                cmd = json.loads(reply)
            except json.JSONDecodeError:
                cmd = {"phrase": reply.strip()}
            if cmd.get("done"):
                break
            phrase = cmd.get("phrase", goal)
            self.processor.reset_all_prompts(state)
            state = self.processor.set_text_prompt(phrase, state)
            scores = np.asarray(state["scores"])
            result = AgentResult(
                phrase=phrase,
                scores=scores,
                masks=np.asarray(state["masks"]),
                boxes=np.asarray(state["boxes"]),
                iterations=it + 1,
            )
            if best is None or (
                len(scores) and scores.max() > (best.scores.max() if len(best.scores) else 0)
            ):
                best = result
            messages.append(
                {
                    "role": "user",
                    "content": (
                        f"phrase '{phrase}': {len(scores)} detections, "
                        f"scores {np.round(scores[:5], 3).tolist()}"
                    ),
                }
            )
        return best


# ---------------------------------------------------------------------------
# Full tool-call loop (reference agent_core.agent_inference): the MLLM calls
# one tool per turn — segment_phrase / examine_each_mask /
# select_masks_and_return / report_no_mask — over SoM-numbered renders, with
# used-prompt dedup and 3-part history pruning.
# ---------------------------------------------------------------------------


class ToolCallError(ValueError):
    pass


def parse_tool_call(text: str) -> dict:
    """Extract the first <tool>{...}</tool> JSON object (agent_core.py
    tolerates trailing chatter and a doubled closing brace)."""
    if "<tool>" not in text:
        raise ToolCallError(f"no <tool> tag in: {text[:200]!r}")
    body = text.split("<tool>", 1)[1].split("</tool>", 1)[0].strip()
    body = body.replace("}}}", "}}")
    try:
        return json.loads(body)
    except json.JSONDecodeError as e:
        raise ToolCallError(f"invalid tool JSON: {body[:200]!r}") from e


def _count_images(messages) -> int:
    return sum(
        1
        for m in messages
        if isinstance(m.get("content"), list)
        for c in m["content"]
        if isinstance(c, dict) and c.get("type") == "image"
    )


def _prune_messages(messages, used_prompts, latest_prompt, image, query):
    """Keep (1) the system+initial messages, with a do-not-reuse warning
    folded into the initial user turn once prompts have been burned, and
    (2) the latest assistant segment_phrase turn onward (reference
    _prune_messages_for_next_round)."""
    part1 = [messages[0], messages[1]]
    start = None
    for i in range(len(messages) - 1, 1, -1):
        m = messages[i]
        if m.get("role") != "assistant" or not isinstance(m.get("content"), list):
            continue
        if any(
            isinstance(c, dict)
            and c.get("type") == "text"
            and "<tool>" in c.get("text", "")
            and "segment_phrase" in c.get("text", "")
            for c in m["content"]
        ):
            start = i
            break
    part2 = messages[start:] if start is not None else []
    burned = [p for p in sorted(used_prompts) if p != latest_prompt]
    if part2 and burned:
        warn = (
            " The segment_phrase tool was already called with each of these "
            f"text_prompts without a satisfactory result: {burned}. Never "
            "reuse any of them."
        )
        part1[1] = {
            "role": "user",
            "content": [
                {"type": "image", "image": image},
                {"type": "text", "text": _initial_text(query) + warn},
            ],
        }
    return part1 + list(part2)


def _initial_text(query: str) -> str:
    return (
        "The image above is the raw input image. The user query is: "
        f"'{query}'."
    )


def agent_inference(
    image: np.ndarray,
    query: str,
    llm: Callable,
    segment: Optional[Callable] = None,
    processor=None,
    max_generations: int = 24,
    mask_alpha: float = 0.35,
    on_event: Optional[Callable] = None,
):
    """Run the agent session; returns (messages, result, rendered).

    `llm(messages) -> str` is the MLLM (messages carry multimodal content
    lists whose image entries are numpy uint8 arrays — the caller's client
    encodes them however its API wants). `segment(phrase) -> dict` with
    "scores"/"masks"/"boxes" runs grounding; pass `processor` instead to
    derive it from a Sam3Processor. `result` is {"image", "masks",
    "boxes", "scores"}; `rendered` its SoM render.

    Reference: sam3/sam3/agent/agent_core.py:agent_inference (files and
    service endpoints swapped for in-memory arrays and callables).
    """
    from .system_prompts import CHECKING_SYSTEM_PROMPT, GROUNDING_SYSTEM_PROMPT
    from .viz import visualize

    image = np.asarray(image, np.uint8)
    if segment is None:
        if processor is None:
            raise ValueError("pass segment= or processor=")

        def segment(phrase):
            state = processor.set_image(image)
            state = processor.set_text_prompt(phrase, state)
            return {
                "scores": np.asarray(state["scores"]),
                "masks": np.asarray(state["masks"]),
                "boxes": np.asarray(state["boxes"]),
            }

    def emit(kind, **kw):
        if on_event is not None:
            on_event(dict(kind=kind, **kw))

    current = {"image": image, "masks": [], "boxes": [], "scores": []}
    have_result = False
    used_prompts = set()
    latest_prompt = ""
    messages = [
        {"role": "system", "content": GROUNDING_SYSTEM_PROMPT},
        {
            "role": "user",
            "content": [
                {"type": "image", "image": image},
                {"type": "text", "text": _initial_text(query)},
            ],
        },
    ]

    for _generation in range(max_generations):
        reply = llm(messages)
        if reply is None:
            raise ToolCallError("LLM returned None")
        # keep only the first tool call if the model rambles on
        reply = reply.split("</tool>", 1)[0] + "</tool>"
        call = parse_tool_call(reply)
        name = call.get("name")
        params = call.get("parameters", {})
        emit("tool_call", name=name, params=params)
        messages.append(
            {"role": "assistant", "content": [{"type": "text", "text": reply}]}
        )

        if not have_result and name not in ("segment_phrase", "report_no_mask"):
            raise ToolCallError(
                f"first tool must be segment_phrase/report_no_mask, got {name}"
            )

        if name == "segment_phrase":
            phrase = params["text_prompt"]
            if phrase in used_prompts:
                messages.append(
                    {
                        "role": "user",
                        "content": [
                            {
                                "type": "text",
                                "text": (
                                    f"text_prompt '{phrase}' was already "
                                    "used; call segment_phrase with a "
                                    "different (perhaps more general) noun "
                                    "phrase. Never reuse any of: "
                                    f"{sorted(used_prompts)}."
                                ),
                            }
                        ],
                    }
                )
            else:
                used_prompts.add(phrase)
                latest_prompt = phrase
                out = segment(phrase)
                current = {
                    "image": image,
                    "masks": [np.asarray(m, bool) for m in out["masks"]],
                    "boxes": [list(map(float, b)) for b in out["boxes"]],
                    "scores": [float(s) for s in out["scores"]],
                }
                have_result = True
                n = len(current["masks"])
                emit("segment", phrase=phrase, num_masks=n)
                if n == 0:
                    messages.append(
                        {
                            "role": "user",
                            "content": [
                                {
                                    "type": "text",
                                    "text": (
                                        f"segment_phrase('{phrase}') produced "
                                        "no masks. Try a different, perhaps "
                                        "more general noun phrase. The "
                                        f"original query was '{query}'."
                                    ),
                                }
                            ],
                        }
                    )
                else:
                    messages.append(
                        {
                            "role": "user",
                            "content": [
                                {
                                    "type": "text",
                                    "text": (
                                        f"segment_phrase produced {n} masks, "
                                        "numbered in the image below. Compare "
                                        "them against the raw image and the "
                                        f"original query '{query}', then pick "
                                        "your next action."
                                    ),
                                },
                                {
                                    "type": "image",
                                    "image": visualize(
                                        current, mask_alpha=mask_alpha
                                    ),
                                },
                            ],
                        }
                    )

        elif name == "examine_each_mask":
            # the previous user turn carries the SoM image; replace it with
            # a text-only summary so the renumbered render that follows
            # keeps the history at <= 2 images (agent_core.py pops it)
            if (
                len(messages) >= 2
                and messages[-2].get("role") == "user"
                and isinstance(messages[-2].get("content"), list)
                and any(
                    isinstance(c, dict) and c.get("type") == "image"
                    for c in messages[-2]["content"]
                )
            ):
                messages[-2] = {
                    "role": "user",
                    "content": [
                        {
                            "type": "text",
                            "text": (
                                "segment_phrase produced several masks; "
                                "analyze them against the raw image and the "
                                "original query, then pick your next action."
                            ),
                        }
                    ],
                }
            keep = []
            for i in range(len(current["masks"])):
                single, zoomed = visualize(current, zoom_in_index=i)
                check_messages = [
                    {"role": "system", "content": CHECKING_SYSTEM_PROMPT},
                    {
                        "role": "user",
                        "content": [
                            {"type": "text", "text": "The raw input image:"},
                            {"type": "image", "image": image},
                            {
                                "type": "text",
                                "text": f"The user query: '{query}'",
                            },
                            {
                                "type": "text",
                                "text": "Image with the candidate mask:",
                            },
                            {"type": "image", "image": single},
                            {"type": "text", "text": "Zoomed-in view:"},
                            {"type": "image", "image": zoomed},
                        ],
                    },
                ]
                verdict_text = llm(check_messages)
                verdict = (
                    verdict_text.split("<verdict>")[-1]
                    .split("</verdict>")[0]
                    .strip()
                )
                emit("verdict", index=i, verdict=verdict)
                if "Accept" in verdict and "Reject" not in verdict:
                    keep.append(i)
                elif not ("Reject" in verdict and "Accept" not in verdict):
                    raise ToolCallError(
                        f"bad verdict for mask {i}: {verdict_text[:200]!r}"
                    )
            current = {
                "image": image,
                "masks": [current["masks"][i] for i in keep],
                "boxes": [current["boxes"][i] for i in keep],
                "scores": [current["scores"][i] for i in keep],
            }
            n = len(keep)
            if n == 0:
                messages.append(
                    {
                        "role": "user",
                        "content": [
                            {
                                "type": "text",
                                "text": (
                                    "examine_each_mask rejected every mask. "
                                    "Call segment_phrase again with a "
                                    "different noun phrase. The original "
                                    f"query was '{query}'."
                                ),
                            }
                        ],
                    }
                )
            else:
                messages.append(
                    {
                        "role": "user",
                        "content": [
                            {
                                "type": "text",
                                "text": (
                                    f"After examine_each_mask, {n} masks "
                                    "remain, renumbered in the image below. "
                                    "Analyze them and pick your next action. "
                                    f"The original query was '{query}'."
                                ),
                            },
                            {
                                "type": "image",
                                "image": visualize(
                                    current, mask_alpha=mask_alpha
                                ),
                            },
                        ],
                    }
                )

        elif name == "select_masks_and_return":
            wanted = params["final_answer_masks"]
            valid = set(range(1, len(current["masks"]) + 1))
            keep = sorted({int(i) for i in wanted if int(i) in valid})
            final = {
                "image": image,
                "masks": [current["masks"][i - 1] for i in keep],
                "boxes": [current["boxes"][i - 1] for i in keep],
                "scores": [current["scores"][i - 1] for i in keep],
            }
            return messages, final, visualize(final, mask_alpha=mask_alpha)

        elif name == "report_no_mask":
            final = {"image": image, "masks": [], "boxes": [], "scores": []}
            return messages, final, image.copy()

        else:
            raise ToolCallError(f"unknown tool: {name}")

        messages = _prune_messages(
            messages, used_prompts, latest_prompt, image, query
        )
        assert _count_images(messages) <= 2

    raise ToolCallError(f"exceeded max_generations={max_generations}")
