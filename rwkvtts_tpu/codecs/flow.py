"""Flow-matching mel generator for the CosyVoice path + first-party SFM.

Functional JAX port. Behavioral parity sources (/root/reference):
  * flow wrapper (zero-shot inference): third_party/cosyvoice/flow/flow.py:155-241
    (CausalMaskedDiffWithXvec: xvec-norm+affine, prompt/token concat, encoder,
     conds = prompt mel zero-padded, 10-step euler with CFG)
  * CFM euler solver + cosine t-schedule + CFG doubling:
    third_party/cosyvoice/flow/flow_matching.py:37-122
  * CFM training loss: flow_matching.py:145-185
  * estimator UNet (CausalConditionalDecoder): third_party/cosyvoice/flow/decoder.py:87-300,
    model/flow/decoder.py:294-500 (causal variant: causal convs, chunked attn)
  * SFM head / losses / inference: model/flow/sfm_head.py, model/flow/flow.py:15-180,
    model/flow/flow_matching.py:24-244

Everything is channels-last (B, T, C), jittable with static step counts
(fixed 10-step euler -> one compiled program, no host round-trips).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rwkvtts_tpu.codecs import conformer, nn

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    in_channels: int = 320  # 80 x + 80 mu + 80 spk + 80 cond (cosy2)
    out_channels: int = 80
    channels: Tuple[int, ...] = (256,)
    n_blocks: int = 4
    num_mid_blocks: int = 12
    num_heads: int = 8
    attention_head_dim: int = 64
    causal: bool = True
    static_chunk_size: int = 0  # 0 => full attention (offline)


@dataclasses.dataclass(frozen=True)
class CFMConfig:
    sigma_min: float = 1e-6
    t_scheduler: str = "cosine"
    training_cfg_rate: float = 0.2
    inference_cfg_rate: float = 0.7


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 6561
    token_mel_ratio: int = 2
    pre_lookahead_len: int = 3
    encoder: conformer.UpsampleConformerConfig = conformer.UpsampleConformerConfig()
    estimator: EstimatorConfig = EstimatorConfig()
    cfm: CFMConfig = CFMConfig()
    n_timesteps: int = 10
    # SFM extras
    sfm: bool = False
    sfm_strength: float = 2.5


# ---------------------------------------------------------------------------
# Estimator building blocks (matcha/diffusers-style, channels-last)


def _sinusoidal_t_emb(t, dim: int, scale: float = 1000.0):
    """matcha SinusoidalPosEmb: t (B,) -> (B, dim)."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = jnp.exp(jnp.arange(half) * -emb)
    ang = scale * t[:, None] * freqs[None, :]
    return jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)


def _mish(x):
    return x * jnp.tanh(jax.nn.softplus(x))


def _block1d_init(key, dim, dim_out, causal: bool):
    p = {"conv": nn.conv1d_init(key, dim, dim_out, 3)}
    if causal:
        p["ln"] = nn.layer_norm_init(dim_out)
    else:
        p["gn"] = {"g": jnp.ones((dim_out,)), "b": jnp.zeros((dim_out,))}
    return p


def _group_norm8(p, x):
    """GroupNorm(8) over channels-last (B, T, C)."""
    B, T, C = x.shape
    g = 8
    xg = x.reshape(B, T, g, C // g)
    mu = jnp.mean(xg, axis=(1, 3), keepdims=True)
    var = jnp.var(xg, axis=(1, 3), keepdims=True)
    xg = (xg - mu) * jax.lax.rsqrt(var + 1e-5)
    return xg.reshape(B, T, C) * p["g"] + p["b"]


def _block1d(p, x, mask, causal: bool):
    x = x * mask
    if causal:
        x = jnp.pad(x, ((0, 0), (2, 0), (0, 0)))
        x = nn.conv1d(p["conv"], x, padding=0)
        x = nn.layer_norm(p["ln"], x, eps=1e-5)
    else:
        x = nn.conv1d(p["conv"], x, padding=1)
        x = _group_norm8(p["gn"], x)
    return _mish(x) * mask


def _resnet_block_init(key, dim, dim_out, time_dim, causal):
    ks = jax.random.split(key, 4)
    return {
        "mlp": nn.linear_init(ks[0], time_dim, dim_out),
        "block1": _block1d_init(ks[1], dim, dim_out, causal),
        "block2": _block1d_init(ks[2], dim_out, dim_out, causal),
        "res_conv": nn.conv1d_init(ks[3], dim, dim_out, 1),
    }


def _resnet_block(p, x, mask, t_emb, causal):
    h = _block1d(p["block1"], x, mask, causal)
    h = h + nn.linear(p["mlp"], _mish(t_emb))[:, None, :]
    h = _block1d(p["block2"], h, mask, causal)
    return h + nn.conv1d(p["res_conv"], x * mask, padding=0)


def _transformer_block_init(key, dim, heads, head_dim):
    ks = jax.random.split(key, 5)
    inner = heads * head_dim
    ff_inner = dim * 4
    return {
        "norm1": nn.layer_norm_init(dim),
        "to_q": nn.linear_init(ks[0], dim, inner, bias=False),
        "to_k": nn.linear_init(ks[1], dim, inner, bias=False),
        "to_v": nn.linear_init(ks[2], dim, inner, bias=False),
        "to_out": nn.linear_init(ks[3], inner, dim),
        "norm3": nn.layer_norm_init(dim),
        "ff_in": nn.linear_init(ks[4], dim, ff_inner),
        "ff_out": nn.linear_init(ks[4], ff_inner, dim),
    }


def _transformer_block(p, x, attn_bias, heads, head_dim):
    B, T, D = x.shape
    h = nn.layer_norm(p["norm1"], x, eps=1e-5)
    q = nn.linear(p["to_q"], h).reshape(B, T, heads, head_dim).transpose(0, 2, 1, 3)
    k = nn.linear(p["to_k"], h).reshape(B, T, heads, head_dim).transpose(0, 2, 1, 3)
    v = nn.linear(p["to_v"], h).reshape(B, T, heads, head_dim).transpose(0, 2, 1, 3)
    scores = jnp.einsum("bhid,bhjd->bhij", q, k) / math.sqrt(head_dim)
    if attn_bias is not None:
        scores = scores + attn_bias[:, None, :, :]
    attn = jax.nn.softmax(scores, axis=-1)
    o = jnp.einsum("bhij,bhjd->bhid", attn, v)
    o = o.transpose(0, 2, 1, 3).reshape(B, T, heads * head_dim)
    x = x + nn.linear(p["to_out"], o)
    h = nn.layer_norm(p["norm3"], x, eps=1e-5)
    h = nn.linear(p["ff_in"], h)
    h = nn.gelu(h)
    return x + nn.linear(p["ff_out"], h)


def estimator_init(key, cfg: EstimatorConfig) -> Params:
    chans = tuple(cfg.channels)
    time_dim = chans[0] * 4
    ks = iter(jax.random.split(key, 8 + 3 * (len(chans) * 2 + cfg.num_mid_blocks) * (cfg.n_blocks + 2)))
    p: Params = {
        "time_mlp": {
            "lin1": nn.linear_init(next(ks), cfg.in_channels, time_dim),
            "lin2": nn.linear_init(next(ks), time_dim, time_dim),
        },
        "down": [],
        "mid": [],
        "up": [],
    }
    out_ch = cfg.in_channels
    for i, ch in enumerate(chans):
        is_last = i == len(chans) - 1
        blk = {
            "resnet": _resnet_block_init(next(ks), out_ch, ch, time_dim, cfg.causal),
            "transformers": [
                _transformer_block_init(next(ks), ch, cfg.num_heads, cfg.attention_head_dim)
                for _ in range(cfg.n_blocks)
            ],
        }
        if is_last:
            blk["downsample"] = nn.conv1d_init(next(ks), ch, ch, 3)
        else:
            blk["downsample"] = nn.conv1d_init(next(ks), ch, ch, 3)  # stride 2
        p["down"].append(blk)
        out_ch = ch
    for _ in range(cfg.num_mid_blocks):
        p["mid"].append(
            {
                "resnet": _resnet_block_init(next(ks), chans[-1], chans[-1], time_dim, cfg.causal),
                "transformers": [
                    _transformer_block_init(next(ks), chans[-1], cfg.num_heads, cfg.attention_head_dim)
                    for _ in range(cfg.n_blocks)
                ],
            }
        )
    up_chans = chans[::-1] + (chans[0],)
    for i in range(len(up_chans) - 1):
        in_ch, ch = up_chans[i] * 2, up_chans[i + 1]
        is_last = i == len(up_chans) - 2
        blk = {
            "resnet": _resnet_block_init(next(ks), in_ch, ch, time_dim, cfg.causal),
            "transformers": [
                _transformer_block_init(next(ks), ch, cfg.num_heads, cfg.attention_head_dim)
                for _ in range(cfg.n_blocks)
            ],
        }
        if is_last:
            blk["upsample"] = nn.conv1d_init(next(ks), ch, ch, 3)
        else:
            blk["upsample"] = nn.conv_transpose1d_init(next(ks), ch, ch, 4)
        p["up"].append(blk)
    p["final_block"] = _block1d_init(next(ks), up_chans[-1], up_chans[-1], cfg.causal)
    p["final_proj"] = nn.conv1d_init(next(ks), up_chans[-1], cfg.out_channels, 1)
    return p


def _chunk_attn_bias(mask, chunk_size: int):
    """mask: (B, T) padding mask -> additive bias (B, T, T). chunk_size 0 =>
    full attention within padding (offline); >0 => wenet static chunk mask
    with all left context."""
    B, T = mask.shape
    valid = (mask[:, None, :] > 0)
    if chunk_size > 0:
        pos = jnp.arange(T)
        ok = (pos[None, :] // chunk_size) <= (pos[:, None] // chunk_size)
        valid = valid & ok[None, :, :]
    return jnp.where(valid, 0.0, -1e10)


def estimator_apply(p: Params, cfg: EstimatorConfig, x, mask, mu, t, spks, cond):
    """All channels-last: x/mu/cond (B, T, 80), mask (B, T), t (B,),
    spks (B, spk_dim) -> velocity (B, T, 80)."""
    t_emb = _sinusoidal_t_emb(t, cfg.in_channels)
    t_emb = nn.linear(p["time_mlp"]["lin1"], t_emb)
    t_emb = nn.linear(p["time_mlp"]["lin2"], jax.nn.silu(t_emb))

    T = x.shape[1]
    h = jnp.concatenate(
        [x, mu, jnp.broadcast_to(spks[:, None, :], (x.shape[0], T, spks.shape[-1])), cond],
        axis=-1,
    )
    m = mask[:, :, None]
    attn_bias = _chunk_attn_bias(mask, cfg.static_chunk_size)

    hiddens = []
    for blk in p["down"]:
        h = _resnet_block(blk["resnet"], h, m, t_emb, cfg.causal)
        for tb in blk["transformers"]:
            h = _transformer_block(tb, h, attn_bias, cfg.num_heads, cfg.attention_head_dim)
        hiddens.append(h)
        # deployed configs use a single channel level => "downsample" is a
        # stride-1 (causal) conv, T is preserved
        if cfg.causal:
            h = jnp.pad(h * m, ((0, 0), (2, 0), (0, 0)))
            h = nn.conv1d(blk["downsample"], h, padding=0)
        else:
            h = nn.conv1d(blk["downsample"], h * m, padding=1)

    for blk in p["mid"]:
        h = _resnet_block(blk["resnet"], h, m, t_emb, cfg.causal)
        for tb in blk["transformers"]:
            h = _transformer_block(tb, h, attn_bias, cfg.num_heads, cfg.attention_head_dim)

    for blk in p["up"]:
        skip = hiddens.pop()
        h = jnp.concatenate([h[:, : skip.shape[1]], skip], axis=-1)
        h = _resnet_block(blk["resnet"], h, m, t_emb, cfg.causal)
        for tb in blk["transformers"]:
            h = _transformer_block(tb, h, attn_bias, cfg.num_heads, cfg.attention_head_dim)
        if cfg.causal:
            h = jnp.pad(h * m, ((0, 0), (2, 0), (0, 0)))
            h = nn.conv1d(blk["upsample"], h, padding=0)
        else:
            h = nn.conv1d(blk["upsample"], h * m, padding=1)

    h = _block1d(p["final_block"], h, m, cfg.causal)
    return nn.conv1d(p["final_proj"], h * m, padding=0) * m


# ---------------------------------------------------------------------------
# CFM: euler solver with CFG, training loss


def cfm_solve(
    p_est: Params,
    est_cfg: EstimatorConfig,
    cfm: CFMConfig,
    z,
    mu,
    mask,
    spks,
    cond,
    n_timesteps: int = 10,
):
    """Fixed-step euler ODE with classifier-free guidance (flow_matching.py:71-122).
    z/mu/cond: (B, T, 80); mask: (B, T); spks: (B, D)."""
    ts = jnp.linspace(0.0, 1.0, n_timesteps + 1)
    if cfm.t_scheduler == "cosine":
        ts = 1 - jnp.cos(ts * 0.5 * jnp.pi)

    B = mu.shape[0]
    zeros_mu = jnp.zeros_like(mu)
    zeros_spk = jnp.zeros_like(spks)
    zeros_cond = jnp.zeros_like(cond)
    mu2 = jnp.concatenate([mu, zeros_mu], 0)
    spks2 = jnp.concatenate([spks, zeros_spk], 0)
    cond2 = jnp.concatenate([cond, zeros_cond], 0)
    mask2 = jnp.concatenate([mask, mask], 0)
    rate = cfm.inference_cfg_rate

    def step(x, i):
        t = ts[i]
        dt = ts[i + 1] - ts[i]
        x2 = jnp.concatenate([x, x], 0)
        t2 = jnp.full((2 * B,), t)
        v2 = estimator_apply(p_est, est_cfg, x2, mask2, mu2, t2, spks2, cond2)
        v, v_cfg = v2[:B], v2[B:]
        v = (1.0 + rate) * v - rate * v_cfg
        return x + dt * v, None

    x, _ = jax.lax.scan(step, z, jnp.arange(n_timesteps))
    return x


def cfm_loss(
    p_est: Params,
    est_cfg: EstimatorConfig,
    cfm: CFMConfig,
    key,
    x1,
    mask,
    mu,
    spks,
    cond,
):
    """Standard CFM training loss (flow_matching.py:145-185), channels-last."""
    k_t, k_z, k_cfg = jax.random.split(key, 3)
    B = x1.shape[0]
    t = jax.random.uniform(k_t, (B, 1, 1))
    if cfm.t_scheduler == "cosine":
        t = 1 - jnp.cos(t * 0.5 * jnp.pi)
    z = jax.random.normal(k_z, x1.shape)
    y = (1 - (1 - cfm.sigma_min) * t) * z + t * x1
    u = x1 - (1 - cfm.sigma_min) * z

    if cfm.training_cfg_rate > 0:
        keep = (jax.random.uniform(k_cfg, (B,)) > cfm.training_cfg_rate)
        mu = mu * keep[:, None, None]
        spks = spks * keep[:, None]
        cond = cond * keep[:, None, None]

    pred = estimator_apply(p_est, est_cfg, y, mask, mu, t[:, 0, 0], spks, cond)
    m = mask[:, :, None]
    loss = jnp.sum(((pred - u) * m) ** 2) / (jnp.sum(m) * u.shape[-1])
    return loss, y


# ---------------------------------------------------------------------------
# SFM head


def sfm_head_init(key, d_hidden: int, mel_channels: int) -> Params:
    ks = jax.random.split(key, 3)
    return {
        "conv1": nn.conv1d_init(ks[0], d_hidden, d_hidden, 3),
        "ln1": nn.layer_norm_init(d_hidden),
        "conv2": nn.conv1d_init(ks[1], d_hidden, d_hidden, 3),
        "ln2": nn.layer_norm_init(d_hidden),
        "proj": nn.linear_init(ks[2], d_hidden, mel_channels + 2),
    }


def sfm_head_apply(p: Params, h, mel_channels: int):
    """h: (B, T, C) -> (x_h (B, T, mel), t_h (B, 1), log_sigma_sq (B, 1))."""
    x = nn.conv1d(p["conv1"], h, padding=1)
    x = jax.nn.relu(nn.layer_norm(p["ln1"], x, eps=1e-5))
    x = nn.conv1d(p["conv2"], x, padding=1)
    x = jax.nn.relu(nn.layer_norm(p["ln2"], x, eps=1e-5))
    x = nn.linear(p["proj"], x)
    x_h = x[..., :mel_channels]
    t_h = jnp.mean(jax.nn.sigmoid(x[..., mel_channels : mel_channels + 1]), axis=1)
    log_sig = jnp.mean(x[..., mel_channels + 1 :], axis=1)
    return x_h, t_h, log_sig


def _positional_noise(key, shape, idx=None):
    """Per-frame counter-based gaussian noise: z[:, t] depends only on
    (key, idx[t]), so prefixes are STABLE as the sequence grows. This
    replaces the reference's flow_cache (flow_matching.py:57-65, which
    caches z/mu for the prompt+overlap region between streaming hops) —
    with stable noise every hop re-derives exactly the same prefix, no
    cache needed.

    idx: optional (T,) int vector of ABSOLUTE frame indices (default
    arange(T)); the windowed streaming path passes shifted indices so a
    bounded token window reproduces the same noise the full sequence
    would see at those absolute positions."""
    B, T, C = shape
    if idx is None:
        idx = jnp.arange(T)
    keys = jax.vmap(lambda t: jax.random.fold_in(key, t))(idx)
    z = jax.vmap(lambda k: jax.random.normal(k, (B, C)))(keys)  # (T, B, C)
    return jnp.moveaxis(z, 0, 1)


# ---------------------------------------------------------------------------
# Flow wrapper (CausalMaskedDiffWithXvec)


def init_params(key, cfg: FlowConfig) -> Params:
    ks = jax.random.split(key, 6)
    p: Params = {
        "input_embedding": 0.02 * jax.random.normal(ks[0], (cfg.vocab_size, cfg.input_size)),
        "spk_affine": nn.linear_init(ks[1], cfg.spk_embed_dim, cfg.output_size),
        "encoder": conformer.init_params(ks[2], cfg.encoder),
        "encoder_proj": nn.linear_init(ks[3], cfg.encoder.output_size, cfg.output_size),
        "estimator": estimator_init(ks[4], cfg.estimator),
    }
    if cfg.sfm:
        p["sfm_head"] = sfm_head_init(ks[5], cfg.encoder.output_size, cfg.output_size)
    return p


def encode_tokens(p: Params, cfg: FlowConfig, tokens, token_mask):
    """tokens: (B, Tt) -> encoder hidden (B, Tt*ratio, enc_dim)."""
    emb = p["input_embedding"][jnp.clip(tokens, 0)] * token_mask[:, :, None]
    return conformer.apply(p["encoder"], cfg.encoder, emb, mask=token_mask)


def inference(
    p: Params,
    cfg: FlowConfig,
    key,
    tokens,
    token_mask,
    prompt_feat,
    prompt_feat_len: int,
    spk_embedding,
    n_timesteps: Optional[int] = None,
    noise=None,
):
    """Zero-shot mel generation (flow.py:194-241).

    tokens: (B, Tt) prompt+target speech tokens (already concatenated);
    token_mask: (B, Tt); prompt_feat: (B, Tp, 80) prompt mel (Tp =
    prompt_token_len * token_mel_ratio); spk_embedding: (B, 192).
    noise: optional explicit (B, T_mel, 80) initial CFM noise — replaces
    the positional draw (golden-fixture replay of the reference's
    CausalConditionalCFM.rand_noise, flow_matching.py:190,212).
    Returns generated mel (B, Tt*ratio - Tp, 80).
    """
    n_timesteps = n_timesteps or cfg.n_timesteps
    emb = spk_embedding * jax.lax.rsqrt(
        jnp.sum(spk_embedding**2, -1, keepdims=True) + 1e-12
    )
    spks = nn.linear(p["spk_affine"], emb)

    h = encode_tokens(p, cfg, tokens, token_mask)
    mu = nn.linear(p["encoder_proj"], h)  # (B, T_mel, 80)

    T_mel = mu.shape[1]
    mel_mask = jnp.repeat(token_mask, cfg.token_mel_ratio, axis=1).astype(mu.dtype)
    conds = jnp.zeros_like(mu)
    conds = jax.lax.dynamic_update_slice(
        conds, prompt_feat.astype(mu.dtype), (0, 0, 0)
    )

    z = _positional_noise(key, mu.shape) if noise is None else noise
    feat = cfm_solve(
        p["estimator"], cfg.estimator, cfg.cfm, z, mu, mel_mask, spks, conds,
        n_timesteps=n_timesteps,
    )
    return feat[:, prompt_feat_len:]


def inference_window(
    p: Params,
    cfg: FlowConfig,
    key,
    tokens,
    token_mask,
    prompt_feat,
    prompt_len: int,
    gen_start,
    spk_embedding,
    n_timesteps: Optional[int] = None,
):
    """Bounded-window streaming hop (incremental-state replacement for the
    reference's full-prefix re-synthesis, cli/model.py:372-404).

    tokens: (B, Wt) = [prompt tokens | generated-token window | right pad],
    a FIXED-capacity buffer so every hop reuses one compiled program;
    token_mask marks valid entries. prompt_len: static prompt token count.
    gen_start: traced absolute index (into the generated-token stream) of
    the first window token after the prompt — used to shift the positional
    noise so window frames see the same noise the full sequence would at
    those absolute positions. Returns mel for the WHOLE window
    (B, Wt*ratio, 80); the caller slices out the newly generated frames.

    Per-hop cost is O(prompt + window), constant in utterance length —
    unlike the reference (and our `inference`-per-prefix path) whose hop
    cost grows linearly with the prefix, i.e. quadratically overall."""
    n_timesteps = n_timesteps or cfg.n_timesteps
    ratio = cfg.token_mel_ratio
    emb = spk_embedding * jax.lax.rsqrt(
        jnp.sum(spk_embedding**2, -1, keepdims=True) + 1e-12
    )
    spks = nn.linear(p["spk_affine"], emb)

    h = encode_tokens(p, cfg, tokens, token_mask)
    mu = nn.linear(p["encoder_proj"], h)  # (B, Wt*ratio, 80)

    mel_mask = jnp.repeat(token_mask, ratio, axis=1).astype(mu.dtype)
    conds = jnp.zeros_like(mu)
    conds = jax.lax.dynamic_update_slice(
        conds, prompt_feat.astype(mu.dtype), (0, 0, 0)
    )

    pos = jnp.arange(mu.shape[1])
    abs_idx = jnp.where(
        pos < ratio * prompt_len, pos, pos + ratio * gen_start
    )
    z = _positional_noise(key, mu.shape, idx=abs_idx)
    feat = cfm_solve(
        p["estimator"], cfg.estimator, cfg.cfm, z, mu, mel_mask, spks, conds,
        n_timesteps=n_timesteps,
    )
    return feat


def sfm_inference_window(
    p: Params,
    cfg: FlowConfig,
    key,
    tokens,
    token_mask,
    prompt_len: int,
    gen_start,
    spk_embedding,
    n_timesteps: Optional[int] = None,
):
    """Bounded-window streaming hop on the SFM fast-decode path.

    Same window contract as `inference_window` (fixed-capacity
    [prompt | ctx | hop+lookahead] buffer, absolute-position noise via
    `gen_start` so window frames reproduce the full-sequence noise), but
    the ODE starts at t_h from the SFM head's coarse prediction
    (model/flow/flow.py:132-180) — roughly half the estimator passes of
    the CFM-10 hop at n_timesteps=5. Prompt conditioning rides as
    concatenated tokens, as in the reference SFM path (no conds), so no
    prompt_feat argument. Returns mel for the WHOLE window
    (B, Wt*ratio, 80); the caller slices the new frames."""
    n_timesteps = n_timesteps or cfg.n_timesteps
    ratio = cfg.token_mel_ratio
    alpha = cfg.sfm_strength
    sigma_min = cfg.cfm.sigma_min

    emb = spk_embedding * jax.lax.rsqrt(
        jnp.sum(spk_embedding**2, -1, keepdims=True) + 1e-12
    )
    spks = nn.linear(p["spk_affine"], emb)

    h = encode_tokens(p, cfg, tokens, token_mask)
    mu = nn.linear(p["encoder_proj"], h)
    x_h, t_h, log_sig = sfm_head_apply(p["sfm_head"], h, cfg.output_size)
    sigma_h = jnp.exp(0.5 * log_sig)

    delta = jnp.maximum(alpha * ((1 - sigma_min) * t_h + sigma_h), 1.0)
    x_h_bar = (alpha / delta)[:, :, None] * x_h
    t_h_bar = (alpha / delta) * t_h
    sig_sq_bar = (alpha**2 / delta**2) * sigma_h**2

    pos = jnp.arange(mu.shape[1])
    abs_idx = jnp.where(pos < ratio * prompt_len, pos, pos + ratio * gen_start)
    z = _positional_noise(key, mu.shape, idx=abs_idx)
    noise_sq = jnp.maximum((1 - (1 - sigma_min) * t_h_bar) ** 2 - sig_sq_bar, 0.0)
    x = jnp.sqrt(noise_sq)[:, :, None] * z + x_h_bar

    mel_mask = jnp.repeat(token_mask, ratio, axis=1).astype(mu.dtype)
    conds = jnp.zeros_like(mu)

    t0 = t_h_bar[:, 0]

    def step(x, i):
        t = t0 + (1.0 - t0) * i / n_timesteps
        dt = (1.0 - t0) / n_timesteps
        v = estimator_apply(
            p["estimator"], cfg.estimator, x, mel_mask, mu, t, spks, conds
        )
        return x + dt[:, None, None] * v, None

    x, _ = jax.lax.scan(step, x, jnp.arange(n_timesteps))
    return x


def sfm_inference(
    p: Params,
    cfg: FlowConfig,
    key,
    tokens,
    token_mask,
    spk_embedding,
    n_timesteps: Optional[int] = None,
):
    """SFM fast decode: start the ODE at t_h from the coarse prediction
    (model/flow/flow_matching.py:24-90). Returns mel (B, T_mel, 80)."""
    n_timesteps = n_timesteps or cfg.n_timesteps
    alpha = cfg.sfm_strength
    sigma_min = cfg.cfm.sigma_min

    emb = spk_embedding * jax.lax.rsqrt(
        jnp.sum(spk_embedding**2, -1, keepdims=True) + 1e-12
    )
    spks = nn.linear(p["spk_affine"], emb)

    h = encode_tokens(p, cfg, tokens, token_mask)
    mu = nn.linear(p["encoder_proj"], h)
    x_h, t_h, log_sig = sfm_head_apply(p["sfm_head"], h, cfg.output_size)
    sigma_h = jnp.exp(0.5 * log_sig)

    # x_h is at encoder-hidden rate == mel rate here (encoder upsamples), so
    # no interpolation needed; Eq. 22 scaling:
    delta = jnp.maximum(alpha * ((1 - sigma_min) * t_h + sigma_h), 1.0)  # (B,1)
    x_h_bar = (alpha / delta)[:, :, None] * x_h
    t_h_bar = (alpha / delta) * t_h
    sig_sq_bar = (alpha**2 / delta**2) * sigma_h**2

    # counter-based per-frame noise (same iid gaussian distribution as
    # random.normal) so the windowed streaming variant reproduces this
    # path bit-for-bit at matching absolute positions
    z = _positional_noise(key, mu.shape)
    noise_sq = jnp.maximum((1 - (1 - sigma_min) * t_h_bar) ** 2 - sig_sq_bar, 0.0)
    x = jnp.sqrt(noise_sq)[:, :, None] * z + x_h_bar

    mel_mask = jnp.repeat(token_mask, cfg.token_mel_ratio, axis=1).astype(mu.dtype)
    conds = jnp.zeros_like(mu)

    # euler from t_h_bar to 1 (no CFG, matching the reference SFM path);
    # per-sample start times -> per-sample dt
    t0 = t_h_bar[:, 0]
    B = mu.shape[0]

    def step(x, i):
        t = t0 + (1.0 - t0) * i / n_timesteps
        dt = (1.0 - t0) / n_timesteps
        v = estimator_apply(p["estimator"], cfg.estimator, x, mel_mask, mu, t, spks, conds)
        return x + dt[:, None, None] * v, None

    x, _ = jax.lax.scan(step, x, jnp.arange(n_timesteps))
    return x


def sfm_loss(p: Params, cfg: FlowConfig, key, tokens, token_mask, x1, feat_mask, spk_embedding):
    """Four-term SFM training loss (model/flow/flow.py:64-121):
    L_coarse + L_t + L_sigma + (L_cfm + L_mu). Channels-last."""
    k1, k2, k3 = jax.random.split(key, 3)
    sigma_min = cfg.cfm.sigma_min

    emb = spk_embedding * jax.lax.rsqrt(
        jnp.sum(spk_embedding**2, -1, keepdims=True) + 1e-12
    )
    spks = nn.linear(p["spk_affine"], emb)
    h = encode_tokens(p, cfg, tokens, token_mask)
    x_g = nn.linear(p["encoder_proj"], h)
    x_h, t_h, log_sig = sfm_head_apply(p["sfm_head"], h, cfg.output_size)

    m = feat_mask[:, :, None]
    loss_coarse = jnp.mean(jnp.abs(x_g * m - x1 * m))

    # orthogonal projection targets (flow.py:87-98)
    x_h_sg = jax.lax.stop_gradient(x_h)
    dot = jnp.sum(x_h_sg * x1, axis=(1, 2))
    t_true = jnp.clip(dot / (jnp.sum(x1 * x1, axis=(1, 2)) + 1e-8), 0.0, 1.0)[:, None]
    sig_sq_true = jnp.maximum(
        jnp.mean((x_h_sg - t_true[:, :, None] * x1) ** 2, axis=(1, 2)), 1e-7
    )[:, None]

    loss_t = jnp.mean((t_h - t_true) ** 2)
    loss_sigma = jnp.mean((log_sig - jnp.log(sig_sq_true)) ** 2)

    # piecewise CFM (flow_matching.py:176-227)
    B = x1.shape[0]
    sigma_h = jnp.sqrt(sig_sq_true)
    delta = jnp.maximum((1 - sigma_min) * t_true + sigma_h, 1.0)
    x_h_bar = (1.0 / delta)[:, :, None] * x_h
    t_h_bar = (1.0 / delta) * t_true
    sig_sq_bar = (1.0 / delta**2) * sig_sq_true

    x0 = jax.random.normal(k1, x1.shape)
    noise_sq = jnp.maximum((1 - (1 - sigma_min) * t_h_bar) ** 2 - sig_sq_bar, 0.0)
    x_t_h = jnp.sqrt(noise_sq)[:, :, None] * x0 + x_h_bar

    t_u = jax.random.uniform(k2, (B, 1, 1)) * (1 - t_h_bar[:, :, None]) + t_h_bar[:, :, None]
    x_t = (1 - t_u) * jax.lax.stop_gradient(x_t_h) + t_u * (x1 + sigma_min * x0)
    u_t = (1.0 / (1.0 - jax.lax.stop_gradient(t_true)[:, :, None] + 1e-8)) * (
        (x1 + sigma_min * x0) - jax.lax.stop_gradient(x_t_h)
    )
    t_s = (1 - t_h_bar[:, :, None]) * t_u + t_h_bar[:, :, None]

    mu = x_g
    cond = jnp.zeros_like(mu)
    if cfg.cfm.training_cfg_rate > 0:
        keep = jax.random.uniform(k3, (B,)) > cfg.cfm.training_cfg_rate
        mu = mu * keep[:, None, None]
        spks = spks * keep[:, None]

    pred = estimator_apply(
        p["estimator"], cfg.estimator, x_t, feat_mask, mu, t_s[:, 0, 0], spks, cond
    )
    loss_cfm = jnp.sum(((pred - u_t) * m) ** 2) / (jnp.sum(m) * u_t.shape[-1])
    loss_mu = jnp.mean((x_h - t_true[:, :, None] * x1) ** 2)

    total = loss_coarse + loss_t + loss_sigma + loss_cfm + loss_mu
    return total, {
        "loss_coarse": loss_coarse,
        "loss_t": loss_t,
        "loss_sigma": loss_sigma,
        "loss_cfm": loss_cfm,
        "loss_mu": loss_mu,
    }
