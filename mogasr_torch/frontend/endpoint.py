"""Causal streaming endpointing: decide DURING decoding when an utterance
has ended, from chunked audio alone.
The port's copy of mogasr/frontend/endpoint.py, its imports pointed at mogasr_torch.


The offline VAD (frontend/vad.py) anchors its threshold on global energy
percentiles, which a streaming recognizer cannot see. This endpointer is
strictly causal: an adaptive noise floor tracks the running minimum frame
energy (rising slowly so a long silence cannot freeze it low forever), and
three Kaldi-style rules fire on top of the resulting speech/silence stream:

  rule 1: speech was seen, then >= rule1_trailing_sil_s of silence
  rule 2: NO speech seen yet and >= rule2_no_speech_s elapsed
  rule 3: utterance reached rule3_max_utt_s regardless

Chunk-size invariant by construction: framing is carried exactly across
chunk boundaries (same frames as the offline framer), and every decision is
a function of the frame stream only — tests assert identical endpoint frames
for 1600- vs 160-sample chunkings.

No reference file can be cited (SURVEY.md §0: reference is empty);
endpointing is the standard online-decoding component the capability spec's
streaming config presumes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from mogasr_torch.config import FrontendConfig


@dataclass(frozen=True)
class EndpointConfig:
    rule1_trailing_sil_s: float = 0.5   # trailing silence after speech
    rule2_no_speech_s: float = 5.0      # nothing ever said
    rule3_max_utt_s: float = 20.0       # hard utterance cap
    threshold_db: float = 20.0          # speech is this far above the floor
    floor_rise_db_per_s: float = 6.0    # adaptive floor recovery rate
    min_speech_frames: int = 3          # debounce before "speech seen"


class StreamingEndpointer:
    """Feed audio chunks; read back whether (and why) an endpoint fired.

    >>> ep = StreamingEndpointer(FrontendConfig())
    >>> for chunk in chunks:
    ...     ep.feed(chunk)
    ...     if ep.endpointed: break
    """

    def __init__(
        self,
        fcfg: FrontendConfig,
        cfg: EndpointConfig = EndpointConfig(),
    ) -> None:
        self.fcfg = fcfg
        self.cfg = cfg
        self._buf = np.zeros(0, np.float32)
        self._floor: Optional[float] = None
        self._frames_seen = 0
        self._speech_run = 0
        self._speech_seen = False
        self._trailing_sil = 0
        self._fired: Optional[str] = None
        self._fired_frame: Optional[int] = None
        ms = fcfg.frame_shift_ms
        self._r1 = max(int(cfg.rule1_trailing_sil_s * 1000 / ms), 1)
        self._r2 = max(int(cfg.rule2_no_speech_s * 1000 / ms), 1)
        self._r3 = max(int(cfg.rule3_max_utt_s * 1000 / ms), 1)
        ln10_per_db = np.log(10.0) / 10.0
        self._thresh_ln = cfg.threshold_db * ln10_per_db
        self._rise_ln = (
            cfg.floor_rise_db_per_s * ln10_per_db * ms / 1000.0
        )

    @property
    def endpointed(self) -> bool:
        return self._fired is not None

    @property
    def rule(self) -> Optional[str]:
        return self._fired

    @property
    def endpoint_frame(self) -> Optional[int]:
        return self._fired_frame

    @property
    def frames_seen(self) -> int:
        return self._frames_seen

    def feed(self, chunk: np.ndarray) -> Optional[str]:
        """Consume one audio chunk; returns the rule name if an endpoint
        fires inside this chunk (state latches — later feeds are no-ops)."""
        if self._fired is not None:
            return self._fired
        self._buf = np.concatenate(
            [self._buf, np.asarray(chunk, np.float32)]
        )
        flen, hop = self.fcfg.frame_length, self.fcfg.frame_shift
        n = max(0, (len(self._buf) - flen) // hop + 1) if len(self._buf) >= flen else 0
        for i in range(n):
            fr = self._buf[i * hop : i * hop + flen]
            e = float(np.log(max(np.sum(fr.astype(np.float64) ** 2), 1e-12)))
            self._step_frame(e)
            if self._fired is not None:
                break
        self._buf = self._buf[n * hop :]
        return self._fired

    def _step_frame(self, e: float) -> None:
        # adaptive floor: drops instantly to new minima, rises slowly
        if self._floor is None:
            self._floor = e
        elif e < self._floor:
            self._floor = e
        else:
            self._floor += self._rise_ln
        is_speech = e > self._floor + self._thresh_ln
        self._frames_seen += 1
        if is_speech:
            self._speech_run += 1
            if self._speech_run >= self.cfg.min_speech_frames:
                self._speech_seen = True
            self._trailing_sil = 0
        else:
            self._speech_run = 0
            self._trailing_sil += 1
        if self._speech_seen and self._trailing_sil >= self._r1:
            self._fire("rule1_trailing_silence")
        elif not self._speech_seen and self._frames_seen >= self._r2:
            self._fire("rule2_no_speech")
        elif self._frames_seen >= self._r3:
            self._fire("rule3_max_length")

    def _fire(self, rule: str) -> None:
        self._fired = rule
        self._fired_frame = self._frames_seen

    def reset(self) -> None:
        """Start a new utterance (keeps the learned noise floor)."""
        self._frames_seen = 0
        self._speech_run = 0
        self._speech_seen = False
        self._trailing_sil = 0
        self._fired = None
        self._fired_frame = None
        self._buf = np.zeros(0, np.float32)
