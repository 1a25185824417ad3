"""Public inference API: `MingUniVisionInfer` (counterpart of mingunivision_tpu/api.py)
on the explicit-params path.

Construct it with a param tree (`utils/convert.params_from_jax` or
`utils/convert.init_mm_params`) and a processor or tokenizer; loading a
checkpoint directory waits until one is available to test against.
"""

from __future__ import annotations

from typing import List, Optional

from mingunivision_tpu_torch.config import (
    GenerationConfig,
    ImageGenConfig,
    MingUniVisionConfig,
    RuntimeConfig,
    with_pixdec_precision,
)
from mingunivision_tpu_torch.processing.image_ops import save_image_with_suffix
from mingunivision_tpu_torch.processing.processor import BailingMMProcessor
from mingunivision_tpu_torch.engine.session import MingUniVisionSession


class MingUniVisionInfer:
    def __init__(
        self,
        model_path: Optional[str] = None,
        *,
        params=None,
        config: Optional[MingUniVisionConfig] = None,
        runtime: Optional[RuntimeConfig] = None,
        tokenizer=None,
        processor: Optional[BailingMMProcessor] = None,
        seed: int = 0,
        device=None,
    ):
        if params is None:
            raise NotImplementedError(f"checkpoint loading ({model_path!r}) is not ported yet; pass params=")
        self.config = config or MingUniVisionConfig()
        self.runtime = runtime or RuntimeConfig()
        if self.runtime.pixdec_matmul_precision is not None:
            # serving-tier pixel decode; the model default ("high") is true fp32
            self.config = with_pixdec_precision(self.config, self.runtime.pixdec_matmul_precision)
        self.params = params
        if processor is None:
            if tokenizer is None:
                raise ValueError("need a tokenizer or processor")
            processor = BailingMMProcessor(tokenizer)
        self.processor = processor
        self.session = MingUniVisionSession(params, self.config, self.runtime, seed=seed, device=device)

    def generate(
        self,
        messages: List[dict],
        max_new_tokens: int = 512,
        output_image_prefix: str = "output",
        for_edit: bool = False,
        image_gen_temperature: float = 1.0,
        image_gen_text_cfg: float = 3.0,
        image_gen_image_cfg: float = 1.1,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        n_images: int = 1,
    ) -> str:
        """Template -> processor -> session.generate -> decoded reply, with the
        JAX API's arguments in its order. Each generated image (3, H, W) in
        [-1, 1] is kept in `last_images` and written as a PNG at
        `output_image_prefix` (`prefix.png`, or `prefix_1.png`, ... when the
        name is taken). `n_images` variants of each image are made in one
        loop (`MingUniVisionSession.generate`); all of them are kept and
        written."""
        text = self.processor.apply_chat_template(messages, add_generation_prompt=True)
        images = self.processor.process_vision_info(messages)
        batch = self.processor(text=text, images=images, for_edit=for_edit)
        gen = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=do_sample, temperature=temperature,
                               top_k=top_k, top_p=top_p, eos_token_id=self.config.llm.eos_token_id)
        ig = self.config.image_gen
        igen = ImageGenConfig(num_image_tokens=ig.num_image_tokens, text_cfg=image_gen_text_cfg,
                              image_cfg=image_gen_image_cfg, temperature=image_gen_temperature,
                              cfg_schedule=ig.cfg_schedule, cfg_renorm_type=ig.cfg_renorm_type,
                              time_shifting_factor=ig.time_shifting_factor)
        out = self.session.generate(batch.input_ids, batch.attention_mask,
                                    uncond_attention_mask=batch.uncond_attention_mask,
                                    text_uncond_attention_mask=batch.text_uncond_attention_mask,
                                    pixel_values=batch.pixel_values, generation=gen, image_gen=igen,
                                    n_images=n_images)
        self.last_images = out.images
        for img in out.images:
            save_image_with_suffix(img, output_image_prefix)
        ids = out.token_ids
        if ids and ids[-1] == self.config.llm.eos_token_id:
            ids = ids[:-1]
        return self.processor.decode(ids)

    def reset_inner_state(self):
        self.session.reset_inner_state()
