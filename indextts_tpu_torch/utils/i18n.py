"""Tiny i18n layer for the web UI (parity: tools/i18n/i18n.py + locale/).

Copy of indextts_tpu/utils/i18n.py.

Locale maps live inline (no loose JSON files to ship); `I18nAuto(lang)` falls
back to the key itself for unknown strings, exactly like the reference's
`language_map.get(key, key)`.
"""

from __future__ import annotations

import locale as _locale
from typing import Dict, Optional

LOCALES: Dict[str, Dict[str, str]] = {
    "en_US": {},  # keys are English already
    "zh_CN": {
        "IndexTTS‑TPU — zero-shot TTS": "IndexTTS‑TPU — 零样本语音合成",
        "Input": "输入",
        "Text": "文本",
        "Speaker prompt (server-side wav path; empty = server default)":
            "音色参考音频（服务端 wav 路径；留空使用默认）",
        "Emotion control": "情感控制",
        "Same as speaker": "与音色参考音频相同",
        "Reference audio": "情感参考音频",
        "Emotion vector": "情感向量",
        "From text": "根据文本推断情感",
        "Emotion reference wav path": "情感参考音频路径",
        "Alpha": "情感权重",
        "Sampling": "采样设置",
        "Synthesize": "合成",
    },
}


def scan_language_list():
    return sorted(LOCALES)


class I18nAuto:
    """Callable translator: i18n('Text') -> localized string."""

    def __init__(self, language: Optional[str] = None):
        if language in ("Auto", None):
            language = _locale.getlocale()[0]
        if language not in LOCALES:
            language = "en_US"
        self.language = language
        self.language_map = LOCALES[language]

    def __call__(self, key: str) -> str:
        return self.language_map.get(key, key)

    def __repr__(self):
        return f"I18nAuto(language={self.language!r})"
