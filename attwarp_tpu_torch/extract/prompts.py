"""Conversation-prompt assembly for LLaVA-style MLLMs.

A copy of ``attwarp_tpu/extract/prompts.py``: the JAX package's
``extract/__init__.py`` imports JAX, so the port cannot import it from
there. ``tests/test_torch_pipeline.py`` pins the two equal.

Behavior parity with the reference prompt path (functions.py:56-90 plus the
vendored LLaVA ``conv_templates`` — not in the snapshot, so template text
follows the public LLaVA repo): the question is prefixed with the image
token, wrapped in the conversation template inferred from the model name,
with an empty assistant turn appended. Each template renders with its own
separator style (SINGLE '###', TWO, LLAMA_2, MPT).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"

LLAVA_V1_SYSTEM = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's "
    "questions."
)
LLAVA_LLAMA2_SYSTEM = (
    "You are a helpful language and vision assistant. You are able to "
    "understand the visual content that the user provides, and assist the "
    "user with a variety of tasks using natural language."
)
MPT_SYSTEM = (
    "<|im_start|>system\nA conversation between a user and an LLM-based AI "
    "assistant. The assistant gives helpful and honest answers."
)


@dataclass(frozen=True)
class ConvTemplate:
    system: str
    role_user: str
    role_assistant: str
    sep: str
    sep2: Optional[str] = None
    style: str = "two"  # "two" | "single" | "llama_2" | "mpt"

    def render(self, user_msg: str) -> str:
        """System + one user turn + empty assistant turn, in this template's
        separator style (LLaVA conversation.py get_prompt semantics)."""
        if self.style == "single":
            # SINGLE: system + sep + 'Role: msg' + sep + 'Role:'
            return (
                f"{self.system}{self.sep}{self.role_user}: {user_msg}"
                f"{self.sep}{self.role_assistant}:"
            )
        if self.style == "llama_2":
            sys_wrapped = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" if self.system else ""
            return f"[INST] {sys_wrapped}{user_msg} [/INST]"
        if self.style == "mpt":
            # MPT: system + sep + '<|im_start|>user\nmsg' + sep + '<|im_start|>assistant\n'
            return (
                f"{self.system}{self.sep}{self.role_user}\n{user_msg}"
                f"{self.sep}{self.role_assistant}\n"
            )
        # TWO (llava_v1): system + ' ' + 'USER: msg' + ' ' + 'ASSISTANT:'
        prefix = (self.system + self.sep) if self.system else ""
        return f"{prefix}{self.role_user}: {user_msg}{self.sep}{self.role_assistant}:"

    @property
    def stop_str(self) -> str:
        return self.sep2 if self.sep2 is not None else self.sep


CONV_TEMPLATES = {
    "llava_v1": ConvTemplate(
        system=LLAVA_V1_SYSTEM,
        role_user="USER",
        role_assistant="ASSISTANT",
        sep=" ",
        sep2="</s>",
        style="two",
    ),
    "llava_v0": ConvTemplate(
        system=LLAVA_V1_SYSTEM,
        role_user="Human",
        role_assistant="Assistant",
        sep="###",
        style="single",
    ),
    "llava_llama_2": ConvTemplate(
        system=LLAVA_LLAMA2_SYSTEM,
        role_user="USER",
        role_assistant="ASSISTANT",
        sep="<s>",
        sep2="</s>",
        style="llama_2",
    ),
    "mpt": ConvTemplate(
        system=MPT_SYSTEM,
        role_user="<|im_start|>user",
        role_assistant="<|im_start|>assistant",
        sep="<|im_end|>",
        style="mpt",
    ),
    "plain": ConvTemplate(
        system="", role_user="USER", role_assistant="ASSISTANT", sep="\n", style="two"
    ),
}


def infer_conv_mode(model_name: str) -> str:
    """Model-name -> conversation mode (functions.py:69-76)."""
    name = model_name.lower()
    if "llama-2" in name:
        return "llava_llama_2"
    if "v1" in name:
        return "llava_v1"
    if "mpt" in name:
        return "mpt"
    return "llava_v0"


def build_prompt(
    question: str,
    conv_mode: str = "llava_v1",
    mm_use_im_start_end: bool = False,
) -> str:
    """Insert the image token and render the conversation
    (functions.py:56-90)."""
    image_token_se = DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN
    qs = question
    token = image_token_se if mm_use_im_start_end else DEFAULT_IMAGE_TOKEN
    if IMAGE_PLACEHOLDER in qs:
        qs = qs.replace(IMAGE_PLACEHOLDER, token)
    else:
        qs = token + "\n" + qs
    tmpl = CONV_TEMPLATES.get(conv_mode, CONV_TEMPLATES["llava_v1"])
    return tmpl.render(qs)


def stop_str_for(conv_mode: str) -> str:
    return CONV_TEMPLATES.get(conv_mode, CONV_TEMPLATES["llava_v1"]).stop_str
