"""Prompt builders (reference `prismatic/models/backbones/llm/prompting/`).

The port's copy of `openvla_oft_tpu/processing/prompting.py`.
`PurePromptBuilder` is the one the OFT path uses ("In: ...\nOut: ",
base_prompter.py:28-73); the chat variants cover the other released VLM
backbones.
"""

from __future__ import annotations

from typing import Optional


class PromptBuilder:
    """ABC (reference base_prompter.py:10-26)."""

    def __init__(self, model_family: str, system_prompt: Optional[str] = None):
        self.model_family = model_family
        self.system_prompt = system_prompt

    def add_turn(self, role: str, message: str) -> str:
        raise NotImplementedError

    def get_prompt(self) -> str:
        raise NotImplementedError


class PurePromptBuilder(PromptBuilder):
    """'In: {q}\nOut: {a}</s>' format (reference base_prompter.py:28-73)."""

    def __init__(self, model_family: str = "openvla",
                 system_prompt: Optional[str] = None):
        super().__init__(model_family, system_prompt)
        self.prompt, self.turn_count = "", 0

    def add_turn(self, role: str, message: str) -> str:
        assert (role == "human") if self.turn_count % 2 == 0 else (role == "gpt")
        message = message.replace("<image>", "").strip()
        if self.turn_count % 2 == 0:
            wrapped = f"In: {message}\nOut: "
        else:
            # reference base_prompter.py: empty gpt turns become " " so the
            # sequence tokenizes as [29871, </s>], not bare </s>
            wrapped = f"{message if message != '' else ' '}</s>"
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_potential_prompt(self, message: str) -> str:
        return self.prompt + f"In: {message.replace('<image>', '').strip()}\nOut: "

    def get_prompt(self) -> str:
        return self.prompt


class LLaMa2ChatPromptBuilder(PromptBuilder):
    """[INST] chat format (reference llama2_prompter.py)."""

    SYS = "<<SYS>>\n{}\n<</SYS>>\n\n"

    def __init__(self, model_family: str = "llama2-chat",
                 system_prompt: Optional[str] = None):
        super().__init__(model_family, system_prompt)
        self.system = self.SYS.format(system_prompt) if system_prompt else ""
        self.prompt, self.turn_count = "", 0

    def add_turn(self, role: str, message: str) -> str:
        assert (role == "human") if self.turn_count % 2 == 0 else (role == "gpt")
        message = message.replace("<image>", "").strip()
        if self.turn_count == 0:
            wrapped = f"[INST] {self.system}{message} [/INST] "
        elif self.turn_count % 2 == 0:
            wrapped = f"[INST] {message} [/INST] "
        else:
            # reference base_prompter.py: empty gpt turns become " " so the
            # sequence tokenizes as [29871, </s>], not bare </s>
            wrapped = f"{message if message != '' else ' '}</s>"
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_prompt(self) -> str:
        return self.prompt


class VicunaV15PromptBuilder(PromptBuilder):
    """Vicuna v1.5 'USER:/ASSISTANT:' format with the LLaVA system prompt
    (reference vicuna_v15_prompter.py:14-62)."""

    DEFAULT_SYSTEM = (
        "A chat between a curious user and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the user's questions.")

    def __init__(self, model_family: str = "vicuna",
                 system_prompt: Optional[str] = None):
        super().__init__(model_family, system_prompt)
        self.system = (system_prompt or self.DEFAULT_SYSTEM).strip() + " "
        self.prompt, self.turn_count = "", 0

    def add_turn(self, role: str, message: str) -> str:
        assert (role == "human") if self.turn_count % 2 == 0 else (role == "gpt")
        message = message.replace("<image>", "").strip()
        if self.turn_count == 0:
            wrapped = f"{self.system}USER: {message} ASSISTANT: "
        elif self.turn_count % 2 == 0:
            wrapped = f"USER: {message} ASSISTANT: "
        else:
            wrapped = f"{message or ' '}</s>"
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_prompt(self) -> str:
        # The tokenizer auto-inserts <s>; strip it if present.
        return self.prompt.removeprefix("<s>").rstrip()


class MistralInstructPromptBuilder(PromptBuilder):
    """Mistral-Instruct '[INST] ... [/INST]' format, no system prompt
    (reference mistral_instruct_prompter.py:15-60)."""

    def __init__(self, model_family: str = "mistral-instruct",
                 system_prompt: Optional[str] = None):
        super().__init__(model_family, system_prompt)
        self.prompt, self.turn_count = "", 0

    def add_turn(self, role: str, message: str) -> str:
        assert (role == "human") if self.turn_count % 2 == 0 else (role == "gpt")
        message = message.replace("<image>", "").strip()
        if self.turn_count % 2 == 0:
            wrapped = f"[INST] {message} [/INST] "
        else:
            wrapped = f"{message or ' '}</s>"
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_prompt(self) -> str:
        return self.prompt.removeprefix("<s>").rstrip()


class PhiPromptBuilder(PromptBuilder):
    """Phi-2 'Input:/Output:' format with explicit <|endoftext|> bos/eos
    (reference phi_prompter.py:16-66)."""

    BOS = EOS = "<|endoftext|>"

    def __init__(self, model_family: str = "phi",
                 system_prompt: Optional[str] = None):
        super().__init__(model_family, system_prompt)
        self.prompt, self.turn_count = "", 0

    def add_turn(self, role: str, message: str) -> str:
        assert (role == "human") if self.turn_count % 2 == 0 else (role == "gpt")
        message = message.replace("<image>", "").strip()
        if self.turn_count == 0:
            wrapped = f"{self.BOS}Input: {message}\nOutput: "
        elif self.turn_count % 2 == 0:
            wrapped = f"Input: {message}\nOutput: "
        else:
            wrapped = f"{message or ' '}\n{self.EOS}"
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_prompt(self) -> str:
        return self.prompt.removeprefix(self.BOS).rstrip()


def get_prompt_builder(llm_backbone_id: str) -> PromptBuilder:
    """Backbone -> builder (reference `prismatic/models/backbones/llm/*.py`
    `prompt_builder_fn` properties)."""
    if "pure" in llm_backbone_id or "openvla" in llm_backbone_id:
        return PurePromptBuilder(llm_backbone_id)
    if "vicuna" in llm_backbone_id:
        return VicunaV15PromptBuilder(llm_backbone_id)
    if "mistral" in llm_backbone_id and "instruct" in llm_backbone_id:
        return MistralInstructPromptBuilder(llm_backbone_id)
    if "phi" in llm_backbone_id:
        return PhiPromptBuilder(llm_backbone_id)
    if "chat" in llm_backbone_id:
        return LLaMa2ChatPromptBuilder(llm_backbone_id)
    return PurePromptBuilder(llm_backbone_id)
