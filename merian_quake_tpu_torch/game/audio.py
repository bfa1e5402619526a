"""Headless audio backend: mix QC sound events into a WAV.

The reference builds quakespasm with ``snd_extern:true`` and supplies
the ``SNDDMA_*`` backend through merian's SDLAudioDevice
(the reference's meson.build:24-27, SURVEY.md §2.5) — the game pushes
``sound(e, chan, sample, vol, atten)`` / ``ambientsound`` builtin calls
and the app mixes + spatializes them against the listener. This module
is the same seam headlessly: ``AudioMixer`` consumes the event stream
the native host already captures (native/game/builtins.cc builtins 8
and 74), spatializes with Quake's SND_Spatialize model (distance
attenuation against a 1000-unit nominal clip distance, stereo pan by
the listener's right vector), and renders a 16-bit stereo WAV.

Samples: real Quake ``.wav`` data is loaded when a PAK search path is
available (models/pak.py); without game assets (this environment ships
none) each sample name deterministically synthesizes a short
placeholder waveform whose family (noise burst / chirp / hum / thud)
follows the sample path, so event timing and spatialization are audible
and testable.

Copy of merian_quake_tpu/game/audio.py (jax-free numpy).
"""
from __future__ import annotations

import hashlib
import math
import wave
from dataclasses import dataclass, field

import numpy as np

# Quake: sound_nominal_clip_dist in snd_dma.c
NOMINAL_CLIP_DIST = 1000.0


def load_wav_bytes(data: bytes) -> tuple[int, np.ndarray]:
    """Parse a RIFF WAV (8/16-bit PCM, mono or stereo) → (rate, mono f32).

    Quake's sounds are 8-bit/11025 Hz mono; loaders for 16-bit and
    stereo are included for completeness.
    """
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF WAVE")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            samples = body
        pos += 8 + size + (size & 1)
    if fmt is None or samples is None:
        raise ValueError("missing fmt/data chunk")
    channels = int.from_bytes(fmt[2:4], "little")
    rate = int.from_bytes(fmt[4:8], "little")
    bits = int.from_bytes(fmt[14:16], "little")
    if bits == 8:
        x = np.frombuffer(samples, np.uint8).astype(np.float32)
        x = (x - 128.0) / 128.0
    elif bits == 16:
        x = np.frombuffer(samples, "<i2").astype(np.float32) / 32768.0
    else:
        raise ValueError(f"unsupported bit depth {bits}")
    if channels > 1:
        x = x[: len(x) // channels * channels]
        x = x.reshape(-1, channels).mean(axis=1)
    return rate, x


def _resample(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    if src_rate == dst_rate or len(x) == 0:
        return x
    n = max(int(round(len(x) * dst_rate / src_rate)), 1)
    t = np.linspace(0.0, len(x) - 1, n)
    return np.interp(t, np.arange(len(x)), x).astype(np.float32)


def synth_sample(name: str, rate: int) -> np.ndarray:
    """Deterministic placeholder waveform for a sample name."""
    h = int.from_bytes(hashlib.sha1(name.encode()).digest()[:4], "little")
    rng = np.random.default_rng(h)
    lname = name.lower()

    def env(n, attack=0.005, tau=0.12):
        t = np.arange(n) / rate
        e = np.exp(-t / tau)
        a = np.minimum(t / max(attack, 1e-4), 1.0)
        return (e * a).astype(np.float32)

    t_of = lambda dur: np.arange(int(dur * rate)) / rate
    if "weapons/" in lname or lname.endswith(("fire.wav", "shot.wav")):
        # gunfire: filtered noise burst
        n = int(0.25 * rate)
        x = rng.standard_normal(n).astype(np.float32)
        x = np.convolve(x, np.ones(4) / 4.0, mode="same")
        return x * env(n, tau=0.06)
    if "items/" in lname:
        # pickup: two ascending chirps
        t = t_of(0.22)
        f0 = 500.0 + (h % 400)
        x = np.sin(2 * np.pi * f0 * t) * (t < 0.1)
        x = x + np.sin(2 * np.pi * f0 * 1.5 * t) * (t >= 0.1)
        return (x * np.exp(-t / 0.15)).astype(np.float32)
    if "doors/" in lname or "plats/" in lname:
        # machinery: low square-ish hum
        t = t_of(0.5)
        f0 = 70.0 + (h % 60)
        x = np.sign(np.sin(2 * np.pi * f0 * t)) * 0.5
        x = x + 0.2 * np.sin(2 * np.pi * f0 * 2.7 * t)
        return (x * np.exp(-t / 0.4)).astype(np.float32)
    if "ambience/" in lname:
        # loopable texture: band-passed noise
        n = int(1.0 * rate)
        x = rng.standard_normal(n).astype(np.float32)
        x = np.convolve(x, np.ones(16) / 16.0, mode="same")
        w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
        return (x * w).astype(np.float32)
    if "player/" in lname:
        # thud/grunt: decaying low tone + noise
        t = t_of(0.3)
        f0 = 110.0 + (h % 80)
        x = np.sin(2 * np.pi * f0 * t) + 0.3 * rng.standard_normal(len(t))
        return (x * np.exp(-t / 0.08)).astype(np.float32)
    # default: decaying sine
    t = t_of(0.3)
    f0 = 200.0 + (h % 600)
    return (np.sin(2 * np.pi * f0 * t) * np.exp(-t / 0.1)).astype(np.float32)


@dataclass
class _Voice:
    sample: np.ndarray
    start: float  # seconds on the mix timeline
    lgain: float
    rgain: float
    key: tuple | None  # (ent, channel) for override semantics
    loop: bool = False


@dataclass
class AudioMixer:
    """Event-driven stereo mixer (the SNDDMA seam, headless).

    Feed per-frame events with :meth:`frame`; :meth:`write_wav` renders
    the timeline. Sample data comes from ``search`` (a
    models.pak.FileSearchPath over real game assets) when available,
    else from the procedural synthesizer.
    """

    rate: int = 22050
    search: object | None = None
    _cache: dict = field(default_factory=dict)
    _voices: list = field(default_factory=list)
    _ambients: list = field(default_factory=list)  # (sample, vol, att, org)
    _t_end: float = 0.0

    def sample(self, name: str) -> np.ndarray:
        got = self._cache.get(name)
        if got is None:
            data = None
            if self.search is not None:
                try:
                    data = self.search.read("sound/" + name.lstrip("/"))
                except (KeyError, FileNotFoundError):
                    data = None
            if data is not None:
                rate, x = load_wav_bytes(data)
                got = _resample(x, rate, self.rate)
            else:
                got = synth_sample(name, self.rate)
            self._cache[name] = got
        return got

    @staticmethod
    def spatialize(origin, listener, right, vol, atten):
        """Quake SND_Spatialize: distance roll-off + right-vector pan.
        Returns (lgain, rgain) in [0, 1]."""
        delta = np.asarray(origin, np.float32) - np.asarray(
            listener, np.float32
        )
        dist = float(np.linalg.norm(delta))
        dist_scale = max(1.0 - dist * atten / NOMINAL_CLIP_DIST, 0.0)
        if atten <= 0.0:
            dot = 0.0
            dist_scale = 1.0
        else:
            dot = float(np.dot(delta / max(dist, 1e-6), right))
        rscale = 1.0 + dot
        lscale = 1.0 - dot
        master = float(vol) * dist_scale
        return (
            max(min(lscale * master, 1.0), 0.0),
            max(min(rscale * master, 1.0), 0.0),
        )

    def set_ambients(self, ambients):
        """Register the map's static looping ambients
        [(sample, vol, atten, origin)]."""
        self._ambients = list(ambients)

    def frame(self, t: float, events, listener, right):
        """Schedule one game frame's sound events at timeline time t.

        events: [(ent, channel, sample, vol, atten, origin)] — the
        native host's frame_sound_events(). A sound on an (ent, chan>0)
        already playing overrides it (Quake SND_PickChannel), realized
        here by truncating the previous voice at t."""
        for ent, chan, name, vol, atten, origin in events:
            if not name:
                continue
            lg, rg = self.spatialize(origin, listener, right, vol, atten)
            key = (ent, chan) if chan > 0 else None
            if key is not None:
                for v in self._voices:
                    if v.key == key and not v.loop and v.start < t:
                        n_keep = max(int((t - v.start) * self.rate), 0)
                        v.sample = v.sample[:n_keep]
                self._voices = [v for v in self._voices if len(v.sample)]
            self._voices.append(
                _Voice(self.sample(name), t, lg, rg, key)
            )
        self._t_end = max(self._t_end, t)

    def render(self, duration: float | None = None) -> np.ndarray:
        """Mix the timeline → f32[n, 2] in [-1, 1]."""
        if duration is None:
            duration = self._t_end + 1.0
        n = int(duration * self.rate)
        out = np.zeros((n, 2), np.float32)
        for v in self._voices:
            i0 = int(v.start * self.rate)
            if i0 >= n or len(v.sample) == 0:
                continue
            seg = v.sample[: n - i0]
            out[i0 : i0 + len(seg), 0] += seg * v.lgain
            out[i0 : i0 + len(seg), 1] += seg * v.rgain
        # ambients loop over the whole timeline (constant listener gain
        # per render; per-frame re-spatialization would require a
        # listener path — kept simple: use the last frame call's
        # listener via explicit frame events if needed)
        peak = float(np.abs(out).max())
        if peak > 1.0:
            out /= peak
        return out

    def render_ambients(self, duration, listener, right) -> np.ndarray:
        """Looping ambient bed for a fixed listener."""
        n = int(duration * self.rate)
        out = np.zeros((n, 2), np.float32)
        for name, vol, atten, origin in self._ambients:
            lg, rg = self.spatialize(origin, listener, right, vol, atten)
            if lg <= 0.0 and rg <= 0.0:
                continue
            s = self.sample(name)
            if len(s) == 0:
                continue
            reps = n // len(s) + 1
            loop = np.tile(s, reps)[:n]
            out[:, 0] += loop * lg
            out[:, 1] += loop * rg
        return out

    def write_wav(self, path: str, duration: float | None = None,
                  listener=None, right=None) -> int:
        """Render and write 16-bit stereo WAV; returns sample count."""
        mix = self.render(duration)
        if self._ambients and listener is not None:
            amb = self.render_ambients(
                len(mix) / self.rate, listener,
                right if right is not None else (0.0, 1.0, 0.0),
            )
            mix = mix + amb
            peak = float(np.abs(mix).max())
            if peak > 1.0:
                mix /= peak
        pcm = (np.clip(mix, -1.0, 1.0) * 32767.0).astype("<i2")
        with wave.open(path, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(self.rate)
            w.writeframes(pcm.tobytes())
        return len(pcm)
