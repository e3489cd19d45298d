"""Copy of efficientsam3_tpu/agent/__init__.py.

Agent: MLLM-orchestrated promptable segmentation.

Mirrors the reference agent subsystem (sam3/sam3/agent/): the tool-call
loop (agent_core.py), SoM rendering (helpers/som_utils.py,
helpers/visualizer.py), zoom-in inspection (helpers/zoom_in.py), unified
visualization (viz.py), and the system-prompt pair (system_prompts/).
"""

from .core import (
    AgentResult,
    SegmentationAgent,
    ToolCallError,
    agent_inference,
    openai_chat_client,
    parse_tool_call,
)
from .som import ColorPalette, draw_box, draw_mask, draw_number, overlay_instances
from .system_prompts import CHECKING_SYSTEM_PROMPT, GROUNDING_SYSTEM_PROMPT
from .viz import visualize
from .zoom_in import compute_zoom_boxes, render_zoom_in

__all__ = [
    "AgentResult",
    "SegmentationAgent",
    "ToolCallError",
    "agent_inference",
    "openai_chat_client",
    "parse_tool_call",
    "ColorPalette",
    "draw_box",
    "draw_mask",
    "draw_number",
    "overlay_instances",
    "CHECKING_SYSTEM_PROMPT",
    "GROUNDING_SYSTEM_PROMPT",
    "visualize",
    "compute_zoom_boxes",
    "render_zoom_in",
]
