"""Audio input resolution: URL download / hex decode.

Copied from `voice_tts_tpu/serving/audio_input.py` (stdlib only; the JAX
package's `serving/__init__` imports pydantic).

Behaviour parity with reference `server.py:92-180` including the error
taxonomy (400 invalid input, 408 download timeout, upstream status on HTTP
error, 500 otherwise).
"""

from __future__ import annotations

import re


class ApiError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


def is_hex_string(s: str) -> bool:
    """Hex audio payloads: hex chars, even length, > 100 chars
    (reference `server.py:92-98`)."""
    if not s:
        return False
    return (bool(re.match(r"^[0-9a-fA-F]+$", s)) and len(s) % 2 == 0
            and len(s) > 100)


def is_url(s: str) -> bool:
    return s.startswith(("http://", "https://", "ftp://"))


def download_audio_from_url(url: str, timeout: float = 30.0) -> bytes:
    import requests

    try:
        response = requests.get(url, timeout=timeout)
        response.raise_for_status()
        return response.content
    except requests.Timeout:
        raise ApiError(408, f"Download timeout: {url}")
    except requests.HTTPError as e:
        status = e.response.status_code if e.response is not None else 500
        raise ApiError(status,
                       f"Failed to download audio from URL: HTTP {status}")
    except Exception as e:  # noqa: BLE001
        raise ApiError(500, f"Error downloading audio from URL: {e}")


def get_audio_data(audio_input: str, timeout: float = 30.0) -> bytes:
    if is_url(audio_input):
        return download_audio_from_url(audio_input, timeout)
    if is_hex_string(audio_input):
        try:
            return bytes.fromhex(audio_input)
        except ValueError as e:
            raise ApiError(400, f"Invalid hex encoded audio data: {e}")
    raise ApiError(400, "Invalid audio input format. Must be URL (http://, "
                        "https://) or hex encoded string")
