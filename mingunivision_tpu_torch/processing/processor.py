"""BailingMMProcessor (counterpart of mingunivision_tpu/processing/processor.py):
chat templating, image-token expansion and the three CFG attention masks.

Parity with the reference processing_bailingmm.py: role prefixes and special
tokens, understanding (1024px) vs generation (512px) preprocessing,
image_grid_thw = [1, H/ps, W/ps], the uncond mask that zeros the last HUMAN
turn and the text-uncond mask that zeros its non-image tokens. Video inputs
(the omni family) are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from mingunivision_tpu_torch.processing.image_ops import preprocess_generation, preprocess_understanding

DEFAULT_IMAGE_PATCH_TOKEN = "<imagePatch>"
DEFAULT_IM_START_TOKEN = "<image>"
DEFAULT_IM_END_TOKEN = "</image>"
USER_PREFIX = "<role>HUMAN</role>"
ASSISTANT_PREFIX = "<role>ASSISTANT</role>"
EOT_TOKEN = "<|endoftext|>"


def find_all_subsequences(sequence: Sequence[int], subsequence: Sequence[int]) -> List[int]:
    n, m = len(sequence), len(subsequence)
    if m == 0:
        return []
    return [i for i in range(n - m + 1) if list(sequence[i : i + m]) == list(subsequence)]


def build_cfg_masks(
    input_ids: Sequence[int],
    user_prefix_ids: Sequence[int],
    assistant_prefix_ids: Sequence[int],
    image_token_ids: set,
):
    """(uncond_mask, text_uncond_mask) for one sequence.

    uncond: zeros the span between the LAST <role>HUMAN</role> tag (exclusive)
    and the next <role>ASSISTANT</role> tag (exclusive).
    text_uncond: in the same span, zeros every token that is NOT an image token.
    """
    seq = list(input_ids)
    user_positions = find_all_subsequences(seq, user_prefix_ids)
    assistant_positions = find_all_subsequences(seq, assistant_prefix_ids)
    mask = [1] * len(seq)
    text_mask = [1] * len(seq)
    if user_positions:
        last_user = user_positions[-1]
        next_assistant = next((pos for pos in assistant_positions if pos >= last_user), None)
        span_start = last_user + len(user_prefix_ids)
        if next_assistant is not None:
            for i in range(span_start, next_assistant):
                mask[i] = 0
        span_end = next_assistant if next_assistant is not None else len(seq)
        for i in range(span_start, span_end):
            if seq[i] not in image_token_ids:
                text_mask[i] = 0
    return mask, text_mask


@dataclass
class ProcessorOutput:
    input_ids: np.ndarray  # (1, T) int64
    attention_mask: np.ndarray  # (1, T)
    uncond_attention_mask: np.ndarray  # (1, T)
    text_uncond_attention_mask: np.ndarray  # (1, T)
    pixel_values: Optional[np.ndarray] = None  # (B, 3, S, S) fp32
    image_grid_thw: Optional[np.ndarray] = None  # (B, 3)


class BailingMMProcessor:
    """Tokenizer + image preprocessing + CFG-mask construction.

    `tokenizer` needs `encode(text, add_special_tokens=False) -> List[int]`,
    `convert_tokens_to_ids(token) -> int` and `decode(ids)` (HF fast
    tokenizers qualify)."""

    def __init__(self, tokenizer, und_image_size: int = 1024, gen_image_size: int = 512):
        self.tokenizer = tokenizer
        self.und_image_size = und_image_size
        self.gen_image_size = gen_image_size
        self.user_prefix_ids = list(tokenizer.encode(USER_PREFIX, add_special_tokens=False))
        self.assistant_prefix_ids = list(tokenizer.encode(ASSISTANT_PREFIX, add_special_tokens=False))
        self.image_start_id = tokenizer.convert_tokens_to_ids(DEFAULT_IM_START_TOKEN)
        self.image_patch_id = tokenizer.convert_tokens_to_ids(DEFAULT_IMAGE_PATCH_TOKEN)
        self.image_end_id = tokenizer.convert_tokens_to_ids(DEFAULT_IM_END_TOKEN)
        self.gen_terminator = [tokenizer.convert_tokens_to_ids(EOT_TOKEN)]

    def apply_chat_template(self, conversation: List[Dict], add_generation_prompt: bool = True,
                            system_template: Optional[str] = None) -> str:
        text = ""
        for message in conversation:
            assert message["role"] in ("HUMAN", "ASSISTANT"), message["role"]
            if message["role"] == "ASSISTANT":
                text += ASSISTANT_PREFIX
            content = message["content"]
            if isinstance(content, str):
                content = [{"type": "text", "text": content}]
            image_counts = sum(str(c.get("text", "")).count("<image>") for c in content)
            for c in content:
                if c["type"] == "image":
                    num_images = 1 if not isinstance(c["image"], (list, tuple)) else len(c["image"])
                    if image_counts < num_images:
                        text += ("<IMAGE>\n" * (num_images - image_counts)).rstrip("\n")
                elif c["type"] == "text":
                    text += c["text"]
            if message["role"] == "ASSISTANT":
                text += EOT_TOKEN
                text += USER_PREFIX
        if add_generation_prompt:
            text += ASSISTANT_PREFIX
        sys_prompt = system_template if system_template is not None else USER_PREFIX
        return sys_prompt + text

    def process_vision_info(self, conversation: List[Dict]):
        """The images a conversation references, in order (None when there are none)."""
        images = []
        for message in conversation:
            content = message["content"]
            if isinstance(content, str):
                continue
            for c in content:
                if c.get("type") == "image":
                    imgs = c["image"] if isinstance(c["image"], (list, tuple)) else [c["image"]]
                    images.extend(self._load_image(im) for im in imgs)
        return images or None

    @staticmethod
    def _load_image(im):
        if isinstance(im, str):
            from PIL import Image

            path = im[len("file://") :] if im.startswith("file://") else im
            return Image.open(path).convert("RGB")
        return im

    def _expand_image_tokens(self, text: List[str], image_grid_thw: np.ndarray, special_token: str = "<IMAGE>"):
        out = []
        image_index = 0
        num_query_tokens = np.prod(image_grid_thw, axis=1)
        for sample in text:
            n = sample.count(special_token)
            for i in range(image_index, image_index + n):
                img_text = (DEFAULT_IM_START_TOKEN + int(num_query_tokens[i]) * DEFAULT_IMAGE_PATCH_TOKEN
                            + DEFAULT_IM_END_TOKEN + "\n")
                sample = sample.replace(special_token, img_text, 1)
            image_index += n
            out.append(sample)
        return out

    def __call__(self, text: Union[str, List[str]], images=None, for_edit: bool = False,
                 image_patch_size: int = 32) -> ProcessorOutput:
        if isinstance(text, str):
            text = [text]
        pixel_values = None
        grid = None
        if images is not None:
            pre = preprocess_generation if for_edit else preprocess_understanding
            size = self.gen_image_size if for_edit else self.und_image_size
            processed = [pre(img, size) for img in images]
            pixel_values = np.stack(processed)
            grid = np.array([[1, p.shape[1] // image_patch_size, p.shape[2] // image_patch_size] for p in processed])
            text = self._expand_image_tokens(text, grid)
        assert len(text) == 1, "batch size 1 only (parity with the reference path)"
        ids = list(self.tokenizer.encode(text[0], add_special_tokens=False))
        image_token_ids = {self.image_start_id, self.image_patch_id, self.image_end_id}
        uncond, text_uncond = build_cfg_masks(ids, self.user_prefix_ids, self.assistant_prefix_ids, image_token_ids)
        return ProcessorOutput(
            input_ids=np.array([ids], np.int64),
            attention_mask=np.ones((1, len(ids)), np.int64),
            uncond_attention_mask=np.array([uncond], np.int64),
            text_uncond_attention_mask=np.array([text_uncond], np.int64),
            pixel_values=pixel_values,
            image_grid_thw=grid,
        )

    def decode(self, token_ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        return self.tokenizer.decode(list(token_ids), skip_special_tokens=skip_special_tokens)
