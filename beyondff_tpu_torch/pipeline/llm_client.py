"""Minimal OpenAI-compatible chat-completions client (stdlib HTTP only).

The reference's GPT descriptor path hard-depends on the ``openai`` SDK and an
``OPENAI_API_KEY`` in a ``.env`` file (reference: tools/descriptor_generator.py:
107-130, gpt-3.5-turbo, temperature 0.5, max_tokens 100). Here the same
request shape is issued with ``urllib`` against any OpenAI-compatible
``/chat/completions`` endpoint (configured via ``detector.llm_endpoint``), so
the framework carries no SDK dependency and works against local inference
servers. The client is a plain ``prompt -> text`` callable, matching the
injectable ``llm`` slot in :mod:`beyondff_tpu_torch.pipeline.descriptors`.
The port's copy of beyondff_tpu/pipeline/llm_client.py.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Optional


class ChatCompletionClient:
    """``prompt -> completion text`` over an OpenAI-compatible HTTP API.

    ``endpoint`` is the API base (e.g. ``https://api.openai.com/v1`` or
    ``http://localhost:8000/v1``); the request goes to
    ``{endpoint}/chat/completions``. The API key is read from ``api_key`` or
    the ``api_key_env`` environment variable (reference: OPENAI_API_KEY,
    descriptor_generator.py:110); absent keys simply omit the Authorization
    header, which local servers accept.
    """

    def __init__(
        self,
        endpoint: str,
        model: str = "gpt-3.5-turbo",
        api_key: Optional[str] = None,
        api_key_env: str = "OPENAI_API_KEY",
        temperature: float = 0.5,
        max_tokens: int = 100,
        timeout: float = 60.0,
    ):
        if not endpoint:
            raise ValueError("ChatCompletionClient needs a non-empty endpoint")
        self.endpoint = endpoint.rstrip("/")
        self.model = model
        self.api_key = api_key if api_key is not None else os.environ.get(api_key_env, "")
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.timeout = timeout

    def __call__(self, prompt: str) -> str:
        body = {
            "model": self.model,
            "messages": [{"role": "user", "content": prompt}],
            "temperature": self.temperature,
            "max_tokens": self.max_tokens,
        }
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        req = urllib.request.Request(
            self.endpoint + "/chat/completions",
            data=json.dumps(body).encode("utf-8"),
            headers=headers,
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            payload = json.loads(resp.read().decode("utf-8"))
        choice = payload["choices"][0]
        # chat APIs return message.content; the reference reads the legacy
        # `.text` completions field (descriptor_generator.py:127) — accept
        # both so either server style parses
        message = choice.get("message") or {}
        return message.get("content") or choice.get("text") or ""


def from_config(detector_cfg) -> Optional[ChatCompletionClient]:
    """Build a client from ``DetectorConfig`` fields, or None when no
    endpoint is configured (the injectable-``llm`` path stays available)."""
    endpoint = getattr(detector_cfg, "llm_endpoint", "")
    if not endpoint:
        return None
    return ChatCompletionClient(
        endpoint,
        model=getattr(detector_cfg, "llm_model", "gpt-3.5-turbo"),
        api_key_env=getattr(detector_cfg, "llm_api_key_env", "OPENAI_API_KEY"),
    )
