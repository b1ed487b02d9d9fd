"""Static sequence-layout metadata threaded through the DiT forward pass.

The port's own copy of ttt_video_dit_tpu/models/sequence.py: same fields
and derived properties (tests/test_torch_entry.py holds it to the original). The port imports
nothing of the JAX package.

Equivalent of the reference's ``SequenceMetadata``
(reference: ttt/models/cogvideo/utils.py:219-248) minus the timestep embedding
(which travels as a traced array instead). All fields are Python ints so the
dataclass is hashable and can be closed over / passed statically under jit.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SequenceMetadata:
    text_length: int  # tokens of text per scene
    num_frames: int  # compressed (latent) frames
    num_chunks: int  # number of 3-second scenes / attention segments
    tokens_per_frame: int
    latent_height: int  # latent pixels (pre-patchify)
    latent_width: int
    patch_size: int = 2

    @property
    def grid_height(self) -> int:
        """Token-grid height (latent pixels / patch size) — the rope grid."""
        return self.latent_height // self.patch_size

    @property
    def grid_width(self) -> int:
        return self.latent_width // self.patch_size

    @property
    def seq_text_length(self) -> int:
        return self.text_length * self.num_chunks

    @property
    def num_video_tokens(self) -> int:
        return self.num_frames * self.tokens_per_frame

    @property
    def is_multiscene(self) -> bool:
        return self.num_chunks > 1

    @property
    def frames_per_chunk(self) -> int:
        return self.num_frames // self.num_chunks

    @property
    def base_offset(self) -> int:
        """Tokens per non-initial interleaved scene: text + one chunk of video
        (reference: ttt/models/cogvideo/utils.py:16-26)."""
        return self.frames_per_chunk * self.tokens_per_frame + self.text_length

    @property
    def init_offset(self) -> int:
        """Tokens in the first interleaved scene — it absorbs the remainder
        frames (e.g. the 1 extra latent frame of the first 3s segment)."""
        extra = self.num_frames % self.frames_per_chunk
        return (self.frames_per_chunk + extra) * self.tokens_per_frame + self.text_length
