"""QwenEmotion: text -> the 8-dim emotion vector, through the Qwen3 LM.

Copy of indextts_tpu/runtime/qwen_emo.py (reference infer_v2.py:948-1063):
the chat prompt ("文本情感分类" as the system message), greedy generation,
</think> stripping, the JSON parse with a regex fallback, the swap for
melancholic words, scores clamped to [0, 1.2], and the calm fallback.

`make_generate_fn` turns a Qwen3LM and a tokenizer's encode/decode into
the `generate_fn` QwenEmotion calls; it decodes with a models/qwen3.py
`QwenDecoder`, a captured step per cache capacity on the card.
`build_qwen_emotion` attaches the fine-tuned checkpoint directory; it alone
needs `transformers` (the tokenizer) and `safetensors`, imported inside it.
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, Sequence

CN_KEY_TO_EN = {
    "高兴": "happy",
    "愤怒": "angry",
    "悲伤": "sad",
    "恐惧": "afraid",
    "反感": "disgusted",
    "低落": "melancholic",
    "惊讶": "surprised",
    "自然": "calm",
}
DESIRED_ORDER = ["高兴", "愤怒", "悲伤", "恐惧", "反感", "低落", "惊讶", "自然"]
MELANCHOLIC_WORDS = {
    "低落", "melancholy", "melancholic", "depression", "depressed", "gloomy",
}
THINK_END_TOKEN_ID = 151668  # </think>


class QwenEmotion:
    """Wraps a generate function: (system prompt, text) -> response text."""

    def __init__(self, generate_fn: Callable[[str, str], str], prompt: str = "文本情感分类",
                 max_score: float = 1.2, min_score: float = 0.0):
        self.generate_fn = generate_fn
        self.prompt = prompt
        self.max_score = max_score
        self.min_score = min_score

    def clamp_score(self, v: float) -> float:
        return max(self.min_score, min(self.max_score, v))

    def convert(self, content: Dict[str, float]) -> Dict[str, float]:
        emotion_dict = {CN_KEY_TO_EN[k]: self.clamp_score(content.get(k, 0.0))
                        for k in DESIRED_ORDER}
        if all(v <= 0.0 for v in emotion_dict.values()):
            emotion_dict["calm"] = 1.0
        return emotion_dict

    @staticmethod
    def parse_response(content: str) -> Dict[str, float]:
        try:
            return json.loads(content)
        except json.JSONDecodeError:
            return {m.group(1): float(m.group(2))
                    for m in re.finditer(r'([^\s":.,]+?)"?\s*:\s*([\d.]+)', content)}

    def inference(self, text_input: str) -> Dict[str, float]:
        content = self.parse_response(self.generate_fn(self.prompt, text_input))
        if any(w in text_input.lower() for w in MELANCHOLIC_WORDS):
            content["悲伤"], content["低落"] = (content.get("低落", 0.0),
                                              content.get("悲伤", 0.0))
        return self.convert(content)

    def vector(self, text_input: str) -> List[float]:
        return list(self.inference(text_input).values())


def strip_thinking(output_ids: List[int]) -> List[int]:
    """Drop everything up to and including the last </think>
    (infer_v2.py:1033-1038)."""
    try:
        idx = len(output_ids) - output_ids[::-1].index(THINK_END_TOKEN_ID)
    except ValueError:
        idx = 0
    return output_ids[idx:]


def make_generate_fn(model, encode: Callable[[str, str], Sequence[int]],
                     decode: Callable[[List[int]], str], eos_token_id: int,
                     max_new_tokens: int = 256) -> Callable[[str, str], str]:
    """QwenEmotion's generate_fn over a models/qwen3.py Qwen3LM: `encode`
    (system prompt, user text) -> the chat prompt's ids, greedy decoding of
    up to max_new_tokens by one QwenDecoder (its captured steps kept across
    calls), </think> stripped, `decode` -> the response text."""
    from indextts_tpu_torch.models.qwen3 import QwenDecoder

    decoder = QwenDecoder(model)

    def generate_fn(system_prompt: str, user_text: str) -> str:
        out = decoder.generate(list(encode(system_prompt, user_text)), max_new_tokens,
                               eos_token_id)
        return decode(strip_thinking([int(t) for t in out]))

    generate_fn.decoder = decoder
    return generate_fn


def build_qwen_emotion(model_dir: str, device=None, max_new_tokens: int = 256) -> QwenEmotion:
    """A QwenEmotion over the fine-tuned Qwen3-0.6B checkpoint directory
    (the reference's `qwen0.6bemo4-merge/`): its Hugging Face tokenizer
    (chat template, enable_thinking=False) and its weights (*.safetensors,
    else pytorch_model.bin) in the port's Qwen3LM on `device` (default:
    the card), float32."""
    from pathlib import Path

    import torch
    from transformers import AutoTokenizer

    from indextts_tpu_torch.config import QwenEmoConfig
    from indextts_tpu_torch.models.qwen3 import Qwen3LM
    from indextts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    tokenizer = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
    d = Path(model_dir)
    files = sorted(d.glob("*.safetensors"))
    if files:
        from safetensors.torch import load_file

        sd = {}
        for f in files:
            sd.update(load_file(str(f)))
    else:
        sd = torch.load(d / "pytorch_model.bin", map_location="cpu")
    with torch.device("meta"):
        model = Qwen3LM(QwenEmoConfig(max_new_tokens=max_new_tokens))
    model.load_state_dict({k: v.float().to(dev) for k, v in sd.items()}, assign=True)
    model = model.eval().requires_grad_(False)

    def encode(system_prompt: str, user_text: str):
        text = tokenizer.apply_chat_template(
            [{"role": "system", "content": system_prompt},
             {"role": "user", "content": user_text}],
            tokenize=False, add_generation_prompt=True, enable_thinking=False)
        return tokenizer([text], return_tensors="np")["input_ids"][0]

    def decode(ids):
        return tokenizer.decode(ids, skip_special_tokens=True)

    return QwenEmotion(make_generate_fn(model, encode, decode, tokenizer.eos_token_id,
                                        max_new_tokens))
