"""Plain float32 PyTorch layers of the AppleCider models, written from the
models' published description and kept apart from the program under test.

Nothing here imports the program. Parameter names follow the program's
``state_dict`` so that one state dict made by the benchmark loads into both.
Every product runs in float32 with TF32 off (``no_tf32``). The same code
with each product's operands rounded to bfloat16 (``Precision("bf16")``)
gives the scale of the rounding that the program's bfloat16 brings, and
rounded to float8 (``Precision("fp8")``), the training check's control.

Dropout is replayed from the run's seed (``dropout.DropSource``): a module
in training mode asks its ``drops`` for a keep mask of its activation's
shape, in the order the model's forward reaches its dropout sites.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

def rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and back; for a float8 type, x is first scaled
    by its absolute maximum onto the type's largest finite value."""
    if dtype.itemsize > 1:
        return x.to(dtype).to(torch.float32)
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Round(torch.autograd.Function):
    """Operands rounded in the forward, their gradients in the backward."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return rounded(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return rounded(g, ctx.bwd), None, None


# operand and gradient types of each precision below float32: bfloat16, the
# program's; float8 e4m3 operands with e5m2 gradients, the control's (the
# usual float8 training recipe)
LOWER = {"bf16": (torch.bfloat16, torch.bfloat16),
         "fp8": (torch.float8_e4m3fn, torch.float8_e5m2)}


class Precision:
    """Where products round their operands: ``"f32"`` (none), ``"bf16"`` or
    ``"fp8"`` (``LOWER``)."""

    def __init__(self, name: str = "f32"):
        if name != "f32" and name not in LOWER:
            raise ValueError(f"precision {name!r}: expected f32, bf16 or fp8")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "f32" else _Round.apply(x, *LOWER[self.name])


@contextlib.contextmanager
def no_tf32():
    """float32 products and convolutions in full float32 inside the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class Ref(nn.Module):
    """Base of the reference modules: a shared ``Precision`` and dropout
    source, set on the whole tree by ``configure``."""

    prec: Precision = Precision()
    drops = None

    def configure(self, prec: Precision, drops) -> "Ref":
        for m in self.modules():
            if isinstance(m, Ref):
                m.prec, m.drops = prec, drops
        return self

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """Inverted dropout with the 8-bit rule: keep where the site's u8
        draw is at least round(256 rate), scale kept values by 256 / (256 -
        threshold)."""
        if not self.training or self.drops is None:
            return x
        thresh = int(round(rate * 256.0))
        if thresh == 0:
            return x
        keep = self.drops.bits(x.shape, x.device) >= thresh
        return torch.where(keep, x * (256.0 / (256 - thresh)), torch.zeros_like(x))


class Linear(Ref):
    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(fout, fin))
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x):
        return F.linear(self.prec(x), self.prec(self.weight)) + self.bias


class LayerNorm(Ref):
    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def l2_normalize(x, eps: float = 1e-12):
    return x / torch.clamp(x.norm(dim=-1, keepdim=True), min=eps)


# ------------------------------------------------------------ photometry
class Time2Vec(Ref):
    """t -> [w0 t + b0, sin(w t + b)]."""

    def __init__(self, d: int):
        super().__init__()
        self.w0 = nn.Parameter(torch.zeros(1))
        self.b0 = nn.Parameter(torch.zeros(1))
        self.w = nn.Parameter(torch.zeros(d - 1))
        self.b = nn.Parameter(torch.zeros(d - 1))

    def forward(self, t):
        t = t[..., None]
        return torch.cat([self.w0 * t + self.b0, torch.sin(t * self.w + self.b)], dim=-1)


class SelfAttention(Ref):
    """Multi-head self-attention over (B, L, D), padded keys (True) masked,
    dropout on the normalised probabilities in training mode."""

    def __init__(self, d: int, heads: int, rate: float):
        super().__init__()
        self.heads, self.rate = heads, rate
        self.in_proj = Linear(d, 3 * d)
        self.out_proj = Linear(d, d)

    def forward(self, x, pad):
        B, L, D = x.shape
        H = self.heads
        q, k, v = (t.reshape(B, L, H, D // H).transpose(1, 2)
                   for t in self.in_proj(x).split(D, dim=-1))
        scores = self.prec(q) @ self.prec(k).transpose(-1, -2) / math.sqrt(D // H)
        scores = scores.masked_fill(pad[:, None, None, :], float("-inf"))
        p = torch.softmax(scores, dim=-1)
        if self.training and self.drops is not None:
            thresh = int(round(self.rate * 256.0))
            keep = self.drops.attention_bits(B, H, L, x.device) >= thresh
            p = torch.where(keep, p * (256.0 / (256 - thresh)), torch.zeros_like(p))
        out = self.prec(p) @ self.prec(v)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, D))


class EncoderLayer(Ref):
    """Post-LN transformer layer with a ReLU feed-forward of 4 d."""

    def __init__(self, d: int, heads: int, rate: float):
        super().__init__()
        self.rate = rate
        self.self_attn = SelfAttention(d, heads, rate)
        self.norm1 = LayerNorm(d)
        self.linear1 = Linear(d, 4 * d)
        self.linear2 = Linear(4 * d, d)
        self.norm2 = LayerNorm(d)

    def forward(self, x, pad):
        x = self.norm1(x + self.dropout(self.self_attn(x, pad), self.rate))
        h = self.dropout(torch.relu(self.linear1(x)), self.rate)
        h = self.dropout(self.linear2(h), self.rate)
        return self.norm2(x + h)


class Encoder(Ref):
    def __init__(self, n: int, d: int, heads: int, rate: float):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"layer_{i}", EncoderLayer(d, heads, rate))

    def forward(self, x, pad):
        for i in range(self.n):
            x = getattr(self, f"layer_{i}")(x, pad)
        return x


class Trunk(Ref):
    def __init__(self, d: int, heads: int, layers: int, rate: float):
        super().__init__()
        self.in_proj = Linear(7, d)
        self.time2vec = Time2Vec(d)
        self.cls_tok = nn.Parameter(torch.zeros(1, 1, d))
        self.encoder = Encoder(layers, d, heads, rate)

    def forward(self, x, pad):
        B = x.shape[0]
        h = self.in_proj(x) + self.time2vec(x[..., 0])
        h = torch.cat([self.cls_tok.expand(B, 1, -1), h], dim=1)
        pad = torch.cat([torch.zeros_like(pad[:, :1]), pad], dim=1)
        return self.encoder(h, pad)


class BaselineCLS(Ref):
    """Photometry transformer: the layer-normalised CLS token."""

    def __init__(self, d: int, heads: int, layers: int, rate: float):
        super().__init__()
        self.trunk = Trunk(d, heads, layers, rate)
        self.norm = LayerNorm(d)

    def forward(self, x, pad):
        return self.norm(self.trunk(x, pad)[:, 0])


# --------------------------------------------------------------- spectra
class Conv1d(Ref):
    """'same' cross-correlation of odd width over (B, L, Cin)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        k = self.weight.shape[-1]
        y = F.conv1d(self.prec(x).transpose(1, 2), self.prec(self.weight), padding=k // 2)
        return y.transpose(1, 2) + self.bias


class SpectraBlock(Ref):
    """Conv bank (outputs on channels) -> LayerNorm -> GELU (-> 1x1 conv ->
    max pool of 4)."""

    def __init__(self, cin: int, cout: int, kernel_sizes, pool: bool):
        super().__init__()
        self.n, self.pool = len(kernel_sizes), pool
        for i, k in enumerate(kernel_sizes):
            self.add_module(f"conv_{i}", Conv1d(cin, cout, k))
        self.norm = LayerNorm(cout * self.n)
        if pool:
            self.downsample = Conv1d(cout * self.n, cout, 1)
        self.out_channels = cout if pool else cout * self.n

    def forward(self, x):
        y = gelu(self.norm(torch.cat([getattr(self, f"conv_{i}")(x) for i in range(self.n)], -1)))
        if self.pool:
            y = self.downsample(y)
            B, L, C = y.shape
            y = y[:, : L // 4 * 4].reshape(B, L // 4, 4, C).amax(dim=2)
        return y


class SpectraNet(Ref):
    """Five stages of conv banks, a max over length, then Linear ->
    LayerNorm -> GELU (the embedding); the classifier adds dropout and a
    Linear to the classes."""

    def __init__(self, channels, depths, kernel_sizes_per_stage, head_hidden: int = 384,
                 num_classes: int | None = None, head_dropout: float = 0.5):
        super().__init__()
        self.blocks = []
        cin = 1
        last = len(channels) - 1
        for s, depth in enumerate(depths):
            for d in range(depth):
                block = SpectraBlock(cin, channels[s], kernel_sizes_per_stage[s],
                                     s != last and d == depth - 1)
                self.add_module(f"stage{s}_block{d}", block)
                self.blocks.append(f"stage{s}_block{d}")
                cin = block.out_channels
        self.head_fc1 = Linear(cin, head_hidden)
        self.head_norm = LayerNorm(head_hidden)
        self.head_dropout = head_dropout
        self.classes = num_classes
        if num_classes is not None:
            self.head_fc2 = Linear(head_hidden, num_classes)

    def forward(self, x):
        x = x[..., None]
        for name in self.blocks:
            x = getattr(self, name)(x)
        h = gelu(self.head_norm(self.head_fc1(x.amax(dim=1))))
        if self.classes is None:
            return h
        return self.head_fc2(self.dropout(h, self.head_dropout))


# ------------------------------------------------------ image + metadata
class Conv2d(Ref):
    """Conv over NHWC images."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        y = F.conv2d(self.prec(x).permute(0, 3, 1, 2), self.prec(self.weight), stride=self.stride,
                     padding=self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1) + self.bias


class ConvNeXtBlock(Ref):
    def __init__(self, d: int):
        super().__init__()
        self.dwconv = Conv2d(d, d, 7, padding=3, groups=d)
        self.norm = LayerNorm(d, eps=1e-6)
        self.pwconv1 = Linear(d, 4 * d)
        self.pwconv2 = Linear(4 * d, d)
        self.gamma = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return x + self.pwconv2(gelu(self.pwconv1(self.norm(self.dwconv(x))))) * self.gamma


class ConvNeXt(Ref):
    def __init__(self, depths, dims):
        super().__init__()
        self.depths = tuple(depths)
        self.stem_conv = Conv2d(3, dims[0], 4, stride=4)
        self.stem_norm = LayerNorm(dims[0], eps=1e-6)
        for s, depth in enumerate(self.depths):
            if s:
                self.add_module(f"downsample{s}_norm", LayerNorm(dims[s - 1], eps=1e-6))
                self.add_module(f"downsample{s}_conv", Conv2d(dims[s - 1], dims[s], 2, stride=2))
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", ConvNeXtBlock(dims[s]))
        self.head_norm = LayerNorm(dims[-1], eps=1e-6)

    def forward(self, x):
        x = self.stem_norm(self.stem_conv(x))
        for s, depth in enumerate(self.depths):
            if s:
                x = getattr(self, f"downsample{s}_conv")(getattr(self, f"downsample{s}_norm")(x))
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x)
        return self.head_norm(x.mean(dim=(1, 2)))


class ImageTower(Ref):
    """ConvNeXt features -> an MLP head gated by a tanh head."""

    def __init__(self, out: int, depths, dims):
        super().__init__()
        f = dims[-1]
        self.backbone = ConvNeXt(depths, dims)
        self.main_norm = LayerNorm(f)
        self.main_fc1 = Linear(f, f // 2)
        self.main_fc2 = Linear(f // 2, f)
        self.main_fc3 = Linear(f, out)
        self.aux_norm = LayerNorm(f)
        self.aux_fc = Linear(f, out)

    def forward(self, x):
        feats = self.backbone(x)
        m = self.dropout(torch.relu(self.main_fc1(self.main_norm(gelu(feats)))), 0.4)
        m = self.main_fc3(self.main_fc2(m))
        return m * torch.tanh(self.aux_fc(self.aux_norm(feats)))


class TowerBlock(Ref):
    """out = main(h) sigmoid(gate(h)) + skip(x), h = GELU(start(x)), each
    branch dropping 0.25 after its LayerNorm."""

    def __init__(self, fin: int, hidden: int, out: int):
        super().__init__()
        self.start = Linear(fin, hidden)
        self.gate_norm = LayerNorm(hidden)
        self.gate_fc = Linear(hidden, out)
        self.main_norm = LayerNorm(hidden)
        self.main_fc = Linear(hidden, out)
        self.skip = Linear(fin, out) if fin != out else None

    def forward(self, x):
        h = gelu(self.start(x))
        g = torch.sigmoid(self.gate_fc(self.dropout(self.gate_norm(h), 0.25)))
        m = self.main_fc(self.dropout(self.main_norm(h), 0.25))
        return m * g + (x if self.skip is None else self.skip(x))


# the metadata columns each tower reads, in the order their outputs are
# concatenated (the image tower's output goes between mega and lc)
TOWERS = (
    ("nst1_tower", (0, 2)),
    ("nst2_tower", (1, 3)),
    ("spatial_tower", (2, 3, 4)),
    ("psf_tower", (5, 14)),
    ("mag_tower", (6, 9, 10, 13, 15, 17, 18)),
    ("coord_tower", (7, 8)),
    ("mega_tower", tuple(range(19))),
    ("lc_tower", (6, 9, 10, 13, 15, 17, 18, 19, 20, 21, 22, 23)),
)


class AstroMiNN(Ref):
    """Metadata towers and the image tower, a sigmoid router and the top-2
    weighted sum of the experts."""

    def __init__(self, experts: int, th: int, to: int, fh: int, fo: int, out: int,
                 depths, dims):
        super().__init__()
        self.experts = experts
        sizes = {"nst1_tower": (th, fo), "nst2_tower": (th, fo), "spatial_tower": (th, to),
                 "psf_tower": (th, to), "mag_tower": (2 * th, to), "coord_tower": (th, fo),
                 "mega_tower": (128, to), "lc_tower": (3 * th, to)}
        for name, cols in TOWERS:
            self.add_module(name, TowerBlock(len(cols), *sizes[name]))
        self.image_tower = ImageTower(to, depths, dims)
        width = 6 * to + 3 * fo
        self.router_fc1 = Linear(width, width // 2)
        self.router_fc2 = Linear(width // 2, experts)
        for i in range(experts):
            self.add_module(f"expert_{i}", TowerBlock(width, fh, out))

    def forward(self, meta, image):
        img = self.image_tower(image)  # drawn first, as the model's forward does
        feats = []
        for name, cols in TOWERS:
            if name == "lc_tower":
                feats.append(img)
            feats.append(getattr(self, name)(meta[:, list(cols)]))
        x = torch.cat(feats, dim=-1)
        gates = torch.sigmoid(self.router_fc2(self.dropout(torch.tanh(self.router_fc1(x)), 0.3)))
        self.gates = gates.detach()  # read by the serving check: how clear each routing is
        outs = torch.stack([getattr(self, f"expert_{i}")(x) for i in range(self.experts)], dim=1)
        # the two largest gates of each row; of equal gates the lower expert
        order = torch.argsort(-gates, dim=-1, stable=True)
        top = torch.zeros_like(gates, dtype=torch.bool).scatter_(1, order[:, :2], True)
        return torch.einsum("be,bec->bc", torch.where(top, gates, 0.0), outs)
