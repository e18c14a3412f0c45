"""The port's speech endpoint (api/audio.py) on its standard-library server
against the reference's aiohttp handler (cake_tpu/api/audio.py), both
serving a stand-in speech model that builds its audio with its own
package's AudioOutput: for every request below both answer the same
status, the same content type and the same bytes (WAV and raw PCM alike),
the reference's 400s and 503s included, and echo an adopted request id.
resolve_voice looks a voice up by base name inside --voices-dir only, as
the reference does, and never resolves a path outside it; the job runs
under the admission plane (class `batch` by default, its timeline under
the request id) and checks in after every frame."""
import asyncio
import base64
import gc
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from cake_tpu.api import ApiState, create_app as jax_create_app
from cake_tpu.api.audio import resolve_voice as jax_resolve
from cake_tpu.models.audio.vibevoice import AudioOutput as JaxAudio
from cake_tpu.serve.admission.plane import get_plane as jax_plane
from cake_tpu_torch.api import create_app
from cake_tpu_torch.api.audio import resolve_voice
from cake_tpu_torch.models.audio.vibevoice import AudioOutput
from cake_tpu_torch.obs import TIMELINES
from cake_tpu_torch.utils.wav import decode_wav, encode_wav

torch.set_num_threads(1)
RID = "X-Cake-Request-Id"


@pytest.fixture(autouse=True)
def _collect_reference_engines():
    yield
    gc.collect()


class Speaker:
    """A stand-in model: deterministic samples from the text, a WAV to
    clone read as the real models read it, every call recorded."""

    def __init__(self, audio_cls):
        self.audio_cls, self.calls, self.frames = audio_cls, [], 0

    def generate_speech(self, text, voice=None, voice_wav=None,
                        cfg_scale=1.3, steps=10, on_frame=None):
        if voice_wav is not None:
            decode_wav(voice_wav)              # ValueError: not a WAV
        self.calls.append(dict(text=text, voice=voice, cfg_scale=cfg_scale,
                               steps=steps, wav=voice_wav is not None))
        for i in range(3):
            if on_frame:
                on_frame(i + 1)
                self.frames += 1
        t = np.linspace(0, 1, 480, dtype=np.float32)
        samples = np.sin(t * (7 + len(text))) * 1.2      # some clip
        return self.audio_cls(samples=samples.astype(np.float32),
                              sample_rate=24000)


def _wav_b64() -> str:
    return base64.b64encode(encode_wav(np.zeros(64, np.float32))).decode()


REQUESTS = [
    ("wav", {"input": "hello"}),
    ("pcm", {"input": "hello there", "response_format": "pcm"}),
    ("params", {"input": "x", "cfg_scale": 2.5, "steps": 3}),
    ("empty input", {"input": ""}),
    ("no input", {"voice": "alice"}),
    ("format", {"input": "x", "response_format": "mp3"}),
    ("bad b64", {"input": "x", "voice_b64": "a"}),
    ("b64 not a wav", {"input": "x",
                       "voice_b64": base64.b64encode(b"nope").decode()}),
    ("b64 wav", {"input": "x", "voice_b64": _wav_b64()}),
    ("voice by name", {"input": "x", "voice": "alice"}),
    ("voice path", {"input": "x", "voice": "../outside.safetensors"}),
    ("bad qos", {"input": "x", "qos": "bogus"}),
    ("bad steps", {"input": "x", "steps": "many"}),
    ("raw", b"not json"),
    ("no body", b""),
]


def _port_answer(url, body, headers=None):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url + "/v1/audio/speech", data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read(), \
                r.headers.get(RID)
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read(), \
            e.headers.get(RID)


def _ref_answers(state, bodies, headers=None):
    async def run():
        client = TestClient(TestServer(jax_create_app(state)))
        await client.start_server()
        out = []
        try:
            for body in bodies:
                data = body if isinstance(body, bytes) else \
                    json.dumps(body).encode()
                r = await client.post("/v1/audio/speech", data=data,
                                      headers=headers or {})
                ctype = r.headers.get("Content-Type", "").split(";")[0]
                out.append((r.status, ctype, await r.read(),
                            r.headers.get(RID)))
        finally:
            await client.close()
        return out
    try:
        return asyncio.run(run())
    finally:
        if state.plane is not None:
            state.plane.close()


@pytest.fixture
def voices(tmp_path):
    d = tmp_path / "voices"
    d.mkdir()
    (d / "alice.safetensors").write_bytes(b"x")
    (tmp_path / "outside.safetensors").write_bytes(b"x")
    return str(d)


def test_every_answer_equals_the_reference(voices):
    ref_model, port_model = Speaker(JaxAudio), Speaker(AudioOutput)
    ref = _ref_answers(ApiState(model=None, audio_model=ref_model,
                                voices_dir=voices),
                       [b for _, b in REQUESTS])
    app = create_app(None, None, None, port=0, audio_model=port_model,
                     voices_dir=voices).start()
    try:
        for (name, body), want in zip(REQUESTS, ref):
            got = _port_answer(app.url, body)
            assert got[0] == want[0], (name, got[:3], want[:3])
            if want[0] == 200:
                assert got[1] == want[1] and got[2] == want[2], name
                assert got[3] and got[3].startswith("tts-")
            else:
                assert json.loads(got[2]).keys() == \
                    json.loads(want[2]).keys(), name
    finally:
        app.stop(drain_s=1)
    assert port_model.calls == ref_model.calls
    assert port_model.frames == ref_model.frames > 0
    named = [c["voice"] for c in port_model.calls if c["text"] == "x"]
    assert os.path.join(voices, "alice.safetensors") in named
    assert all(v is None or v.startswith(voices) for v in named)


def test_wav_and_pcm_layouts():
    samples = np.sin(np.linspace(0, 9, 480)).astype(np.float32) * 1.3
    ours, theirs = AudioOutput(samples, 24000), JaxAudio(samples, 24000)
    assert ours.wav_bytes() == theirs.wav_bytes()
    assert ours.pcm_bytes() == theirs.pcm_bytes()
    wav = ours.wav_bytes()
    assert wav[:4] == b"RIFF" and wav[8:16] == b"WAVEfmt "
    back, rate = decode_wav(wav)
    assert rate == 24000 and len(back) == 480
    assert len(ours.pcm_bytes()) == 2 * 480


def test_adopted_id_timeline_and_no_model(voices):
    app = create_app(None, None, None, port=0,
                     audio_model=Speaker(AudioOutput)).start()
    try:
        status, ctype, _, rid = _port_answer(
            app.url, {"input": "hi"}, {RID: "tts-test-1"})
        assert (status, ctype, rid) == (200, "audio/wav", "tts-test-1")
        events = TIMELINES.get("tts-test-1")["events"]
        kinds = [e["kind"] for e in events]
        assert kinds[:1] == ["received"] and "enqueue" in kinds \
            and "admit" in kinds
        assert [e.get("workload") for e in events
                if e["kind"] == "admit"] == ["audio"]
        assert [e.get("qos") for e in events
                if e["kind"] == "enqueue"] == ["batch"]
        app.state.draining = True
        status, _, body, _ = _port_answer(app.url, {"input": "hi"})
        assert status == 503 and b"draining" in body
    finally:
        app.stop(drain_s=1)
    ref = _ref_answers(ApiState(model=None), [{"input": "hi"}])
    none = create_app(None, None, None, port=0).start()
    try:
        got = _port_answer(none.url, {"input": "hi"})
    finally:
        none.stop(drain_s=1)
    assert got[0] == ref[0][0] == 503
    assert json.loads(got[2]) == json.loads(ref[0][2])


@pytest.mark.parametrize("voice", [
    "alice", "alice.safetensors", "../voices/alice", "/etc/passwd",
    "../outside", "..", ".", "", None, "bob", "sub/../../outside"])
def test_resolve_voice_stays_inside_the_directory(voices, voice):
    class S:
        voices_dir = voices
    got, want = resolve_voice(S, voice), jax_resolve(S, voice)
    assert got == want
    if got is not None:
        assert os.path.dirname(got) == voices
    class Unset:
        voices_dir = None
    assert resolve_voice(Unset, voice) is None
