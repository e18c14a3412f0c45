"""Speech endpoint (counterpart of cake_tpu/api/audio.py: resolve_voice,
audio_speech): POST /v1/audio/speech for the standard-library server in
server.py.

    {"input": "text", "response_format": "wav" | "pcm", "voice": NAME,
     "voice_b64": BASE64_WAV, "cfg_scale": 1.3, "steps": 10, "qos": ...}

The synthesis is a GenerationJob of kind "audio" admitted under a QoS
class (`batch` by default) through the admission plane's job lane, as the
image endpoint's: tenant quotas and backpressure answer their typed 429s
before any work starts, the job's timeline is under its request id
(`tts-...` or the adopted X-Cake-Request-Id, echoed), the drain refuses
new jobs, and the job checks in after every frame, so a client that goes
away stops it and queued chat is not held behind a long utterance.
Answers: 503 with no audio model and while draining, 400 for a body that
is not JSON, no `input`, a format other than wav / pcm, a `voice_b64`
that does not decode, or a WAV the job cannot read; the audio as
audio/wav (RIFF, 16-bit PCM) or raw 16-bit PCM
(application/octet-stream). A `voice` is a NAME looked up in the
operator's `--voices-dir`: its base name, or that with `.safetensors`;
a client's string never reaches the file system as a path.
"""
from __future__ import annotations

import base64
import json
import logging
import os

from ..obs import TRACE_HEADER
from .qos import adopt_job_request_id, resolve_admission, run_admitted_job

log = logging.getLogger("cake_tpu_torch.api.audio")


def resolve_voice(state, voice) -> str | None:
    """A client's voice name -> a prompt file inside state.voices_dir, or
    None (no directory configured, or no such file there)."""
    if not voice or not getattr(state, "voices_dir", None):
        if voice:
            log.info("voice %r ignored (no --voices-dir configured)", voice)
        return None
    base = os.path.basename(str(voice))         # drop any path components
    for cand in (base, base + ".safetensors"):
        p = os.path.join(state.voices_dir, cand)
        if os.path.isfile(p):
            return p
    log.info("voice %r not found in voices dir; ignoring", voice)
    return None


def audio_speech(handler, state) -> None:
    """POST /v1/audio/speech."""
    if state.audio_model is None:
        return handler.send_json({"error": "no audio model loaded"}, 503)
    if state.draining:
        return handler.send_json({"error": "server draining for shutdown"},
                                 503, {"Retry-After": "5"})
    try:
        length = int(handler.headers.get("Content-Length") or 0)
        body = json.loads(handler.rfile.read(length))
    except (ValueError, json.JSONDecodeError):
        return handler.send_json({"error": "invalid JSON body"}, 400)
    text = body.get("input") if isinstance(body, dict) else None
    if not text:
        return handler.send_json({"error": "input required"}, 400)
    fmt = body.get("response_format", "wav")
    if fmt not in ("wav", "pcm"):
        return handler.send_json({"error": f"unsupported format {fmt}"}, 400)
    voice = resolve_voice(state, body.get("voice"))
    voice_wav = None
    if body.get("voice_b64"):
        try:
            voice_wav = base64.b64decode(body["voice_b64"])
        except Exception:
            return handler.send_json({"error": "invalid voice_b64"}, 400)
    resolved = resolve_admission(handler, state, body, "batch")
    if resolved is None:
        return None
    qos, tenant, release = resolved
    rid = adopt_job_request_id(handler, "tts")
    gen = state.audio_model.generate_speech

    def run(job):
        # a checkpoint per frame: cancellation and the interactive yield
        return gen(text, voice=voice, voice_wav=voice_wav,
                   cfg_scale=float(body.get("cfg_scale", 1.3)),
                   steps=int(body.get("steps", 10)),
                   on_frame=lambda *a: job.checkpoint())
    try:
        job = run_admitted_job(handler, state, "audio", run, qos, tenant,
                               rid, release)
    except (BrokenPipeError, ConnectionResetError):
        return None                     # the client went away
    if job is None:
        return None
    audio = job.result["value"]
    if fmt == "pcm":
        return handler.send_body(audio.pcm_bytes(), 200,
                                 "application/octet-stream",
                                 {TRACE_HEADER: rid})
    return handler.send_body(audio.wav_bytes(), 200, "audio/wav",
                             {TRACE_HEADER: rid})
