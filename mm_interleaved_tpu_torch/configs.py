"""Model configuration presets, field for field those of
`mm_interleaved_tpu/configs.py`.

  * ``tiny_config``     — CPU-testable miniature of the full architecture.
  * ``small_config``    — ~200M-class scale with the real ViT grid.
  * ``base_config``     — ~1.4B LLM + ViT-L/14 + SD-2.1-base-sized UNet.
  * ``flagship_config`` — reference parity: Vicuna-13B + CLIP ViT-L/14 @224
    + SD-2.1-base @512.
"""

from __future__ import annotations

from .models.image_decoder import ImageDecoderConfig
from .models.llama import LlamaConfig
from .models.mm_interleaved import MMInterleavedConfig, SpecialTokens
from .models.perceiver import PerceiverConfig
from .models.sd.mmfs_net import MMFSNetConfig
from .models.sd.scheduler import DiffusionSchedule
from .models.sd.unet import UNetConfig
from .models.sd.vae import VAEConfig
from .models.visual_tokenizer import VisualTokenizerConfig
from .models.vit import ViTConfig
from .models.vit_adapter import ViTAdapterConfig


def tiny_config(with_image_decoder: bool = True, dtype: str = "float32",
                max_num_images: int = 3,
                scan_layers: bool = True) -> MMInterleavedConfig:
    vit = ViTConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, patch_size=14, image_size=56, dtype=dtype,
    )
    adapter = ViTAdapterConfig(vit=vit, conv_inplane=8, extra_extractors=1)
    llm = LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=4, num_attention_heads=4,
        max_position_embeddings=128, cross_attention_frequency=2,
        image_embed_dim=32, spatial_shapes=(8, 4), mmfs_heads=2,
        mmfs_points=2, max_num_image_per_seq=8, dtype=dtype,
        scan_layers=scan_layers,
    )
    visual = VisualTokenizerConfig(
        encoder=adapter,
        perceiver=PerceiverConfig(
            num_queries=4, hidden_size=16, encoder_hidden_size=32,
            num_hidden_layers=2, num_attention_heads=2,
            cross_attention_frequency=2, qk_normalization=True, dtype=dtype,
        ),
        llm_hidden_size=32,
        grid_size=vit.grid_size,
    )
    image_decoder = None
    if with_image_decoder:
        image_decoder = ImageDecoderConfig(
            vae=VAEConfig(
                block_out_channels=(8, 16, 16), layers_per_block=1,
                norm_num_groups=4,
            ),
            unet=UNetConfig(
                sample_size=4, block_out_channels=(16, 32),
                layers_per_block=1, cross_attention_dim=16,
                attention_head_dim=8, norm_num_groups=4,
                mmfs=MMFSNetConfig(
                    input_channel=32, attn_dim=32, n_heads=4, n_points=2,
                    feat_spatial_shapes=(16, 8, 4, 2),
                    max_num_image_per_seq=4, pos_grid_size=4,
                ),
                dtype=dtype,
            ),
            schedule=DiffusionSchedule(num_train_timesteps=100),
            perceiver=PerceiverConfig(
                num_queries=5, hidden_size=16, encoder_hidden_size=32,
                num_hidden_layers=1, num_attention_heads=2,
                cross_attention_frequency=1, dtype=dtype,
            ),
            image_size=16,
            spatial_shapes=(16, 8, 4, 2),
        )
    return MMInterleavedConfig(
        llm=llm,
        visual=visual,
        image_decoder=image_decoder,
        special=SpecialTokens(
            bos_token_id=1, eos_token_id=2, pad_token_id=120,
            soi_token_id=121, image_token_id=122,
        ),
        seq_len=64,
        num_img_token=4,
        max_num_images=max_num_images,
        max_context_len=16,
        orig_vocab_size=120,
    )


def small_config(dtype: str = "bfloat16", with_image_decoder: bool = True,
                 max_num_images: int = 4, seq_len: int = 512,
                 remat: bool = False,
                 scan_layers: bool = True) -> MMInterleavedConfig:
    vit = ViTConfig(
        hidden_size=256, intermediate_size=1024, num_hidden_layers=8,
        num_attention_heads=8, patch_size=14, image_size=224, dtype=dtype,
    )
    adapter = ViTAdapterConfig(vit=vit, conv_inplane=32)
    llm = LlamaConfig(
        vocab_size=32002, hidden_size=512, intermediate_size=1536,
        num_hidden_layers=8, num_attention_heads=4,
        max_position_embeddings=seq_len, cross_attention_frequency=4,
        image_embed_dim=256, spatial_shapes=(32, 16, 8),
        mmfs_heads=8, mmfs_points=8, max_num_image_per_seq=50,
        dtype=dtype, remat=remat, scan_layers=scan_layers,
    )
    visual = VisualTokenizerConfig(
        encoder=adapter,
        perceiver=PerceiverConfig(
            num_queries=64, hidden_size=256, encoder_hidden_size=256,
            num_hidden_layers=4, num_attention_heads=8,
            cross_attention_frequency=2, qk_normalization=True, dtype=dtype,
        ),
        llm_hidden_size=llm.hidden_size,
        grid_size=vit.grid_size,
    )
    image_decoder = None
    if with_image_decoder:
        image_decoder = ImageDecoderConfig(
            vae=VAEConfig(
                block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                norm_num_groups=16,
            ),
            unet=UNetConfig(
                sample_size=16, block_out_channels=(64, 128, 128),
                layers_per_block=1, cross_attention_dim=256,
                attention_head_dim=32, norm_num_groups=16,
                mmfs=MMFSNetConfig(
                    input_channel=256, attn_dim=256, n_heads=8, n_points=4,
                    feat_spatial_shapes=(64, 32, 16, 8),
                    max_num_image_per_seq=10, pos_grid_size=16,
                ),
                dtype=dtype,
            ),
            schedule=DiffusionSchedule(),
            perceiver=PerceiverConfig(
                num_queries=77, hidden_size=256,
                encoder_hidden_size=llm.hidden_size,
                num_hidden_layers=1, num_attention_heads=8,
                cross_attention_frequency=1, dtype=dtype,
            ),
            image_size=128,
            spatial_shapes=(64, 32, 16, 8),
        )
    return MMInterleavedConfig(
        llm=llm,
        visual=visual,
        image_decoder=image_decoder,
        seq_len=seq_len,
        num_img_token=64,
        max_num_images=max_num_images,
        max_context_len=256,
    )


def base_config(dtype: str = "bfloat16", with_image_decoder: bool = True,
                max_num_images: int = 6, seq_len: int = 2048,
                remat: bool = True,
                scan_layers: bool = True) -> MMInterleavedConfig:
    vit = ViTConfig(dtype=dtype)
    adapter = ViTAdapterConfig(vit=vit)
    llm = LlamaConfig(
        vocab_size=32002, hidden_size=2048, intermediate_size=5504,
        num_hidden_layers=24, num_attention_heads=16,
        max_position_embeddings=seq_len, cross_attention_frequency=4,
        image_embed_dim=1024, spatial_shapes=(32, 16, 8),
        mmfs_heads=16, mmfs_points=8, max_num_image_per_seq=50,
        dtype=dtype, remat=remat, scan_layers=scan_layers,
    )
    visual = VisualTokenizerConfig(
        encoder=adapter,
        perceiver=PerceiverConfig(
            num_queries=64, hidden_size=768, encoder_hidden_size=1024,
            num_hidden_layers=12, num_attention_heads=12,
            cross_attention_frequency=2, qk_normalization=True, dtype=dtype,
        ),
        llm_hidden_size=llm.hidden_size,
        grid_size=vit.grid_size,
    )
    image_decoder = None
    if with_image_decoder:
        image_decoder = _sd21_image_decoder(llm.hidden_size, dtype)
    return MMInterleavedConfig(
        llm=llm,
        visual=visual,
        image_decoder=image_decoder,
        seq_len=seq_len,
        num_img_token=64,
        max_num_images=max_num_images,
        max_context_len=512,
    )


def _sd21_image_decoder(llm_hidden: int, dtype: str) -> ImageDecoderConfig:
    return ImageDecoderConfig(
        vae=VAEConfig(),
        unet=UNetConfig(
            mmfs=MMFSNetConfig(
                input_channel=1024, attn_dim=1024, n_heads=16, n_points=8,
                feat_spatial_shapes=(64, 32, 16, 8),
                max_num_image_per_seq=10, pos_grid_size=64,
            ),
            dtype=dtype,
            remat=True,
        ),
        schedule=DiffusionSchedule(),
        perceiver=PerceiverConfig(
            num_queries=77, hidden_size=1024, encoder_hidden_size=llm_hidden,
            num_hidden_layers=1, num_attention_heads=16,
            cross_attention_frequency=1, dtype=dtype,
        ),
        image_size=512,
        spatial_shapes=(64, 32, 16, 8),
    )


def flagship_config(dtype: str = "bfloat16", max_num_images: int = 10,
                    seq_len: int = 2048) -> MMInterleavedConfig:
    vit = ViTConfig(dtype=dtype)
    adapter = ViTAdapterConfig(vit=vit)
    llm = LlamaConfig(
        vocab_size=32002, hidden_size=5120, intermediate_size=13824,
        num_hidden_layers=40, num_attention_heads=40,
        max_position_embeddings=seq_len, cross_attention_frequency=4,
        image_embed_dim=1024, spatial_shapes=(32, 16, 8),
        mmfs_heads=16, mmfs_points=8, max_num_image_per_seq=50,
        dtype=dtype, remat=True,
        scan_layers=True,
    )
    visual = VisualTokenizerConfig(
        encoder=adapter,
        perceiver=PerceiverConfig(
            num_queries=64, hidden_size=768, encoder_hidden_size=1024,
            num_hidden_layers=12, num_attention_heads=12,
            cross_attention_frequency=2, qk_normalization=True, dtype=dtype,
        ),
        llm_hidden_size=llm.hidden_size,
        grid_size=vit.grid_size,
    )
    return MMInterleavedConfig(
        llm=llm,
        visual=visual,
        image_decoder=_sd21_image_decoder(llm.hidden_size, dtype),
        seq_len=seq_len,
        num_img_token=64,
        max_num_images=max_num_images,
        max_context_len=512,
    )
