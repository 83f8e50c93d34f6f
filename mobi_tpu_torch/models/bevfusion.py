"""BEVFusion detector, inference path (mobi_tpu models/bevfusion.py; the
reference's mmdet3d/models: fusion_models/bevfusion.py:25-310,
backbones/sparse_encoder.py, second.py, necks/second.py, fusers/conv.py,
vtransforms/{base,depth_lss}.py, heads/bbox/transfusion.py).

  camera: Swin-T -> GeneralizedLSSFPN -> DepthLSSTransform -> BEV
  lidar:  hard voxelize (host) -> HardSimpleVFE -> SparseEncoder -> BEV
  fusion: ConvFuser -> SECOND -> SECONDFPN -> TransFusionHead -> boxes

Modules carry the reference's mmdet3d state-dict names
(`encoders.{camera,lidar}.*`, `fuser.*`, `decoder.{backbone,neck}.*`,
`heads.object.*`), so a reference `bevfusion-det.pth` loads with
`load_state_dict(strict=True)`. Where the port's layout differs from the
JAX package's, it follows the reference:

  * the sparse encoder's dense BEV is flattened C-major ([1, C*D, X, Y],
    the reference's `.dense()` view), where JAX is z-major ([X, Y, Z*C]);
  * SECONDFPN's upsampling is an `nn.ConvTranspose2d` that takes the
    reference's weights as they are (JAX mirrors the taps);
  * a detector has a fuser exactly when its state dict has `fuser.0.weight`
    (the reference's lidar-only assembly has none; JAX inserts an identity).

Sparse convolutions run through `ops.sparse_conv` on rulebooks planned on
the host once per cloud (`plan_sparse_encoder`). Images and maps are NCHW;
the BEV grid is [X, Y] as (H, W). The TransFusion attention is plain
PyTorch, as JAX's runs with backend="xla": no hand kernel lies on this path.

BatchNorm normalises by its stored statistics in every mode, and holds them
as parameters (`StatsBatchNorm`), as JAX's `_bn` does
(mobi_tpu/models/bevfusion.py:137-142): training takes their gradients and
AdamW updates and decays them; batch statistics and momentum are never
used (mmdet3d trains on batch statistics: ROADMAP queue 3). The
reference's names (`running_mean`, `running_var`, `num_batches_tracked`)
stay, so a `bevfusion-det.pth` loads strict.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mobi_tpu_torch import native
from mobi_tpu_torch.ops.sparse_conv import Rulebook, build_rulebook, pad_rulebook, sparse_conv_apply
from mobi_tpu_torch.ops.voxel_ops import bev_pool

# ('basicblock' plan) per stage: (channels of each block, strided-conv
# channels, strided-conv pad)
ENCODER_STAGES = (
    ((16, 16), 32, (1, 1, 1)),
    ((32, 32), 64, (1, 1, 1)),
    ((64, 64), 128, (1, 1, 0)),
    ((128, 128), None, None),     # last stage: no strided conv
)


class StatsBatchNorm(nn.Module):
    """BatchNorm over dim 1 of [N, C, ...] (or [V, C] sparse rows) that
    normalises by its stored statistics, `running_mean` and `running_var`
    being parameters: (x - mean) * rsqrt(var + eps) * weight + bias, JAX's
    formula, in train and eval mode alike."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.running_mean = nn.Parameter(torch.zeros(num_features))
        self.running_var = nn.Parameter(torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean.view(shape)) * inv.view(shape) * self.weight.view(shape) + self.bias.view(shape)


def hard_simple_vfe(voxels: torch.Tensor, num_points: torch.Tensor) -> torch.Tensor:
    """[V, max_pts, F], [V] -> [V, F] mean over the real points
    (HardSimpleVFE)."""
    denom = torch.clamp(num_points[:, None], min=1).to(voxels.dtype)
    return voxels.sum(dim=1) / denom


def plan_sparse_encoder(
    coords: np.ndarray,
    sparse_shape: Sequence[int],
) -> Tuple[Dict[str, Rulebook], np.ndarray, Tuple[int, int, int]]:
    """Host-side rulebook plan for SparseEncoder: ({name: Rulebook}, final
    coords, final spatial shape). Each stage's submanifold blocks share one
    rulebook; each stride-2 transition and conv_out get their own. The plan
    is unpadded: eager PyTorch needs no fixed shapes."""
    plans: Dict[str, Rulebook] = {}
    cur = np.asarray(coords, np.int64)
    shape = tuple(int(s) for s in sparse_shape)
    for i, (_, down_ch, pad) in enumerate(ENCODER_STAGES):
        plans[f"subm{i}"] = build_rulebook(cur, (3, 3, 3), submanifold=True)
        if down_ch is not None:
            rb = build_rulebook(cur, (3, 3, 3), stride=(2, 2, 2), padding=pad,
                                spatial_shape=shape, submanifold=False)
            plans[f"down{i}"] = rb
            cur = rb.out_coords.astype(np.int64)
            shape = tuple((shape[d] + 2 * pad[d] - 3) // 2 + 1 for d in range(3))
    plans["out"] = build_rulebook(cur, (1, 1, 3), stride=(1, 1, 2), padding=(0, 0, 0),
                                  spatial_shape=shape, submanifold=False)
    out_shape = (shape[0], shape[1], (shape[2] - 3) // 2 + 1)
    return plans, plans["out"].out_coords.astype(np.int64), out_shape


# ------------------------------------------------------------ sparse encoder
class SparseConv3d(nn.Module):
    """A sparse conv's weight in spconv's layout, (*kernel, C_in, C_out)."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int]):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*kernel, cin, cout))
        fan_out = int(np.prod(kernel)) * cout
        nn.init.normal_(self.weight, std=(2.0 / fan_out) ** 0.5)

    def forward(self, feats: torch.Tensor, rb: Rulebook) -> torch.Tensor:
        w = self.weight
        return sparse_conv_apply(feats, w.reshape(-1, w.shape[-2], w.shape[-1]), rb)


class SparseConvModule(nn.Module):
    """spconv SparseSequential(conv, BatchNorm1d(eps 1e-3), ReLU): children
    "0" and "1", as the reference's state dict names them."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int] = (3, 3, 3)):
        super().__init__()
        self.add_module("0", SparseConv3d(cin, cout, kernel))
        self.add_module("1", StatsBatchNorm(cout, eps=1e-3))

    def forward(self, feats: torch.Tensor, rb: Rulebook) -> torch.Tensor:
        return F.relu(self._modules["1"](self._modules["0"](feats, rb)))


class SparseBasicBlock(nn.Module):
    """Two submanifold convs with a residual (mmdet3d SparseBasicBlock)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = SparseConv3d(ch, ch, (3, 3, 3))
        self.bn1 = StatsBatchNorm(ch, eps=1e-3)
        self.conv2 = SparseConv3d(ch, ch, (3, 3, 3))
        self.bn2 = StatsBatchNorm(ch, eps=1e-3)

    def forward(self, feats: torch.Tensor, rb: Rulebook) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(feats, rb)))
        return F.relu(self.bn2(self.conv2(h, rb)) + feats)


class SparseEncoder(nn.Module):
    """Sparse voxel encoder ('basicblock' plan of the reference's det
    config) -> dense BEV [1, C*D, X, Y], flattened C-major as the
    reference's `.dense()` view (sparse_encoder.py:128-131)."""

    def __init__(self, in_channels: int = 5, base_channels: int = 16, output_channels: int = 128):
        super().__init__()
        self.output_channels = output_channels
        self.conv_input = SparseConvModule(in_channels, base_channels)
        self.encoder_layers = nn.ModuleDict()
        cin = base_channels
        for i, (block_chs, down_ch, _) in enumerate(ENCODER_STAGES):
            layer = nn.ModuleList()
            for ch in block_chs:
                layer.append(SparseBasicBlock(ch))
                cin = ch
            if down_ch is not None:
                layer.append(SparseConvModule(cin, down_ch))
                cin = down_ch
            self.encoder_layers[f"encoder_layer{i + 1}"] = layer
        self.conv_out = SparseConvModule(cin, output_channels, (3, 1, 1))

    def forward(self, feats: torch.Tensor, plans: Dict[str, Rulebook], out_coords: np.ndarray,
                out_shape: Tuple[int, int, int]) -> torch.Tensor:
        h = self.conv_input(feats, plans["subm0"])
        for i, (block_chs, down_ch, _) in enumerate(ENCODER_STAGES):
            layer = self.encoder_layers[f"encoder_layer{i + 1}"]
            for j in range(len(block_chs)):
                h = layer[j](h, plans[f"subm{i}"])
            if down_ch is not None:
                h = layer[len(block_chs)](h, plans[f"down{i}"])
        h = self.conv_out(h, plans["out"])
        return densify_bev(h, out_coords, out_shape)


def densify_bev(h: torch.Tensor, out_coords: np.ndarray, out_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Sparse rows [V, C] at (x, y, z) -> [1, C*Z, X, Y], channel c*Z + z;
    rows whose coordinates lie outside the grid (a padded plan's,
    `ops.sparse_conv.pad_rulebook`) are dropped."""
    X, Y, Z = out_shape
    c = np.asarray(out_coords, np.int64)
    valid = np.nonzero((c >= 0).all(1) & (c < np.asarray([X, Y, Z])).all(1))[0]
    lin = (c[valid, 2] * X + c[valid, 0]) * Y + c[valid, 1]
    dense = h.new_zeros(h.shape[1], Z * X * Y)
    if len(valid):
        dense[:, torch.from_numpy(lin).to(h.device)] = h[torch.from_numpy(valid).to(h.device)].t()
    return dense.reshape(1, h.shape[1] * Z, X, Y)


# ------------------------------------------------------------- dense blocks
def _conv_bn_relu(cin: int, cout: int, stride: int = 1, eps: float = 1e-3) -> List[nn.Module]:
    return [nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False),
            StatsBatchNorm(cout, eps=eps), nn.ReLU()]


class SECONDBackbone(nn.Module):
    """Dense BEV backbone (backbones/second.py): per stage a strided 3x3
    ConvBNReLU and `layer_nums` more; returns each stage's map."""

    def __init__(self, in_channels: int = 256, out_channels: Sequence[int] = (128, 256),
                 layer_nums: Sequence[int] = (5, 5), layer_strides: Sequence[int] = (1, 2)):
        super().__init__()
        self.blocks = nn.ModuleList()
        cin = in_channels
        for ch, n, s in zip(out_channels, layer_nums, layer_strides):
            layers = _conv_bn_relu(cin, ch, s)
            for _ in range(n):
                layers += _conv_bn_relu(ch, ch)
            self.blocks.append(nn.Sequential(*layers))
            cin = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for block in self.blocks:
            x = block(x)
            outs.append(x)
        return outs


class SECONDFPN(nn.Module):
    """Upsample + concat neck (necks/second.py): stride 1 a 1x1 conv,
    stride s > 1 an s x s transposed conv, each with BN and ReLU."""

    def __init__(self, in_channels: Sequence[int] = (128, 256), out_channels: Sequence[int] = (256, 256),
                 upsample_strides: Sequence[int] = (1, 2)):
        super().__init__()
        self.deblocks = nn.ModuleList()
        for cin, ch, s in zip(in_channels, out_channels, upsample_strides):
            up = (nn.ConvTranspose2d(cin, ch, s, stride=s, bias=False) if s > 1
                  else nn.Conv2d(cin, ch, 1, bias=False))
            self.deblocks.append(nn.Sequential(up, StatsBatchNorm(ch, eps=1e-3), nn.ReLU()))

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([d(x) for d, x in zip(self.deblocks, xs)], dim=1)


class ConvFuser(nn.Sequential):
    """Camera + lidar BEV fusion (fusers/conv.py): concat along channels ->
    3x3 conv -> BN -> ReLU, children "0" and "1" as the reference names
    them."""

    def __init__(self, in_channels: int, out_channels: int = 256):
        super().__init__(*_conv_bn_relu(in_channels, out_channels))

    def forward(self, feats) -> torch.Tensor:
        return super().forward(torch.cat(list(feats), dim=1) if isinstance(feats, (list, tuple)) else feats)


class LidarBEVNetwork(nn.Module):
    """Voxel features -> BEV features for the head: sparse encoder -> SECOND
    -> FPN (the lidar-only detector body, no fuser)."""

    def __init__(self, in_channels: int = 5):
        super().__init__()
        self.encoder = SparseEncoder(in_channels)
        self.backbone = SECONDBackbone()
        self.neck = SECONDFPN()

    def forward(self, feats, plans, out_coords, out_shape) -> torch.Tensor:
        return self.neck(self.backbone(self.encoder(feats, plans, out_coords, out_shape)))


# ------------------------------------------------------------ camera to BEV
def build_sparse_depth_map(points: np.ndarray, lidar2image: np.ndarray,
                           image_size: Tuple[int, int]) -> np.ndarray:
    """Host-side sparse depth map for DepthLSSTransform (vtransforms/
    base.py:241-280): project the lidar points into each camera, keep the
    in-frame hits, write the ray distance into [N_cam, 1, iH, iW]."""
    iH, iW = image_size
    n_cam = len(lidar2image)
    depth = np.zeros((n_cam, 1, iH, iW), np.float32)
    pts = np.asarray(points)[:, :3]
    hom = np.concatenate([pts, np.ones((len(pts), 1))], 1)
    for c in range(n_cam):
        proj = hom @ np.asarray(lidar2image[c]).reshape(4, 4).T
        dist = proj[:, 2]
        z = np.clip(dist, 1e-5, 1e5)
        u = proj[:, 0] / z
        v = proj[:, 1] / z
        keep = (u >= 0) & (u < iW) & (v >= 0) & (v < iH)
        depth[c, 0, v[keep].astype(int), u[keep].astype(int)] = dist[keep]
    return depth


def _seq_conv_bn(spec) -> nn.Sequential:
    """An nn.Sequential from a spec: (cin, cout, k, stride, bias) adds a
    conv with padding k // 2; ("bn", channels, eps) a StatsBatchNorm and a
    ReLU after it."""
    layers: List[nn.Module] = []
    for item in spec:
        if item[0] == "bn":
            layers += [StatsBatchNorm(item[1], eps=item[2]), nn.ReLU()]
        else:
            cin, cout, k, s, bias = item
            layers.append(nn.Conv2d(cin, cout, k, stride=s, padding=k // 2, bias=bias))
    return nn.Sequential(*layers)


class DepthLSSTransform(nn.Module):
    """Lift-Splat-Shoot camera -> BEV with lidar depth guidance
    (vtransforms/depth_lss.py:15-101 + base.py:21-206): a small CNN encodes
    the sparse depth map, concatenated with the image features; depthnet
    predicts a D-bin depth distribution and C context channels; their outer
    product is splatted (`ops.voxel_ops.bev_pool`) at the frustum points'
    lidar-frame cells; a strided ConvBNReLU stack halves the grid."""

    def __init__(self, in_channels: int = 256, out_channels: int = 80,
                 image_size: Tuple[int, int] = (256, 704), feature_size: Tuple[int, int] = (32, 88),
                 xbound=(-54.0, 54.0, 0.3), ybound=(-54.0, 54.0, 0.3), zbound=(-10.0, 10.0, 20.0),
                 dbound=(1.0, 60.0, 0.5), downsample: int = 2):
        super().__init__()
        self.out_channels = out_channels
        self.image_size, self.feature_size = tuple(image_size), tuple(feature_size)
        self.xbound, self.ybound, self.zbound, self.dbound = xbound, ybound, zbound, dbound
        self.D = int(round((dbound[1] - dbound[0]) / dbound[2]))
        self.dtransform = _seq_conv_bn([
            (1, 8, 1, 1, True), ("bn", 8, 1e-5), (8, 32, 5, 4, True), ("bn", 32, 1e-5),
            (32, 64, 5, 2, True), ("bn", 64, 1e-5)])
        self.depthnet = _seq_conv_bn([
            (in_channels + 64, in_channels, 3, 1, True), ("bn", in_channels, 1e-5),
            (in_channels, in_channels, 3, 1, True), ("bn", in_channels, 1e-5),
            (in_channels, self.D + out_channels, 1, 1, True)])
        if downsample > 1:
            self.downsample = nn.Sequential(
                *_conv_bn_relu(out_channels, out_channels),
                *_conv_bn_relu(out_channels, out_channels, stride=downsample),
                *_conv_bn_relu(out_channels, out_channels))

    def frustum(self, device, dtype=torch.float32) -> torch.Tensor:
        """[D, fH, fW, 3] (u, v, depth) sample points (base.py:53-77)."""
        iH, iW = self.image_size
        fH, fW = self.feature_size
        ds = self.dbound[0] + self.dbound[2] * torch.arange(self.D, dtype=dtype, device=device)
        xs = torch.linspace(0, iW - 1, fW, dtype=dtype, device=device)
        ys = torch.linspace(0, iH - 1, fH, dtype=dtype, device=device)
        d, y, x = torch.meshgrid(ds, ys, xs, indexing="ij")
        return torch.stack([x, y, d], dim=-1)

    def geometry(self, cam2lidar: torch.Tensor, intrins: torch.Tensor) -> torch.Tensor:
        """Frustum -> lidar-frame xyz [N, D, fH, fW, 3] (base.py:79-122; the
        image augmentation is folded into the matrices)."""
        fr = self.frustum(cam2lidar.device, cam2lidar.dtype)
        uvd = torch.cat([fr[..., :2] * fr[..., 2:3], fr[..., 2:3]], dim=-1)
        combine = cam2lidar[:, :3, :3] @ torch.linalg.inv(intrins)
        pts = torch.einsum("nij,dhwj->ndhwi", combine, uvd)
        return pts + cam2lidar[:, None, None, None, :3, 3]

    def cells(self, cam2lidar: np.ndarray, intrins: np.ndarray) -> torch.Tensor:
        """The frustum points' BEV cells, int32 [N, D, fH, fW, 3] (x, y, z),
        from camera2lidar [N, 4, 4] and the intrinsics [N, 3, 3], on the
        host in float32. The caller's host stage computes them, so the card
        and the CPU splat into the same cells: the card's own rounding could
        send a point within an ulp of a cell edge to its neighbour."""
        geom = self.geometry(torch.as_tensor(np.asarray(cam2lidar, np.float32)),
                             torch.as_tensor(np.asarray(intrins, np.float32)))
        lo = torch.tensor([self.xbound[0], self.ybound[0], self.zbound[0]])
        dx = torch.tensor([self.xbound[2], self.ybound[2], self.zbound[2]])
        # the reference truncates toward zero, not floor (base.py:135)
        return ((geom - lo) / dx).to(torch.int32)

    def forward(self, img_feats: torch.Tensor, depth_map: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
        """img_feats [N, Cin, fH, fW]; depth_map [N, 1, iH, iW]; cells
        [N, D, fH, fW, 3] (`cells`) -> BEV [1, C, X, Y]."""
        d = self.dtransform(depth_map)
        x = self.depthnet(torch.cat([d, img_feats], dim=1))
        depth = x[:, : self.D].softmax(dim=1)                     # [N, D, fH, fW]
        ctx = x[:, self.D:]                                       # [N, C, fH, fW]
        lifted = depth[:, :, :, :, None] * ctx.permute(0, 2, 3, 1)[:, None]  # [N, D, fH, fW, C]

        nx = [int(round((b[1] - b[0]) / b[2])) for b in (self.xbound, self.ybound, self.zbound)]
        vox = cells.reshape(-1, 3)
        coords = torch.stack([torch.zeros_like(vox[:, 0]), vox[:, 2], vox[:, 0], vox[:, 1]], dim=1)
        bev = bev_pool(lifted.reshape(-1, self.out_channels), coords, 1, nx[2], nx[0], nx[1])
        # [1, Z, X, Y, C] -> [1, Z*C, X, Y], channel z*C + c
        bev = bev.permute(0, 1, 4, 2, 3).reshape(1, nx[2] * self.out_channels, nx[0], nx[1])
        if hasattr(self, "downsample"):
            bev = self.downsample(bev)
        return bev


# ------------------------------------------------------------------- head
class _ConvModule1d(nn.Module):
    """Conv1d(k=1) -> BatchNorm1d -> ReLU (mmcv ConvModule names)."""

    def __init__(self, cin: int, cout: int, eps: float = 1e-5):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, 1)
        self.bn = StatsBatchNorm(cout, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class _ConvModule2d(nn.Module):
    def __init__(self, cin: int, cout: int, eps: float = 1e-3):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn = StatsBatchNorm(cout, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class PositionEmbeddingLearned(nn.Module):
    """Learned embedding of (x, y) positions (models/utils/transformer.py:
    14-30): Conv1d -> BN -> ReLU -> Conv1d over [B, 2, P]."""

    def __init__(self, cin: int, ch: int):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            nn.Conv1d(cin, ch, 1), StatsBatchNorm(ch, eps=1e-5), nn.ReLU(), nn.Conv1d(ch, ch, 1))

    def forward(self, pos: torch.Tensor) -> torch.Tensor:  # [B, P, 2] -> [B, P, C]
        return self.position_embedding_head(pos.transpose(1, 2)).transpose(1, 2)


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (in_proj_weight, in_proj_bias,
    out_proj), batch first, dropout off; logits in plain matmuls."""

    def __init__(self, ch: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * ch, ch))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * ch))
        self.out_proj = nn.Linear(ch, ch)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, nq, c = q.shape
        w, bias = self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)
        dh = c // self.heads
        q, k, v = (F.linear(t, wi, bi).reshape(b, t.shape[1], self.heads, dh).transpose(1, 2)
                   for t, wi, bi in zip((q, k, v), w, bias))
        attn = ((q @ k.transpose(-2, -1)) * dh**-0.5).softmax(dim=-1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(b, nq, c))


class TransformerDecoderLayer(nn.Module):
    """DETR-style post-norm decoder layer with learned position embeddings
    (models/utils/transformer.py:33-110); [B, P, C] in and out."""

    def __init__(self, ch: int = 128, heads: int = 8, ffn: int = 256):
        super().__init__()
        self.self_attn = MultiheadAttention(ch, heads)
        self.multihead_attn = MultiheadAttention(ch, heads)
        self.linear1 = nn.Linear(ch, ffn)
        self.linear2 = nn.Linear(ffn, ch)
        self.norm1 = nn.LayerNorm(ch, eps=1e-6)
        self.norm2 = nn.LayerNorm(ch, eps=1e-6)
        self.norm3 = nn.LayerNorm(ch, eps=1e-6)
        self.self_posembed = PositionEmbeddingLearned(2, ch)
        self.cross_posembed = PositionEmbeddingLearned(2, ch)

    def forward(self, query, key, query_pos, key_pos):
        qe = self.self_posembed(query_pos)
        ke = self.cross_posembed(key_pos)
        q = query + qe
        query = self.norm1(query + self.self_attn(q, q, q))
        kk = key + ke
        query = self.norm2(query + self.multihead_attn(query + qe, kk, kk))
        return self.norm3(query + self.linear2(F.relu(self.linear1(query))))


PRED_HEADS = (("center", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2))


class PredictionFFN(nn.Module):
    """Per-quantity 1x1 heads (models/utils/transformer.py:496-545): center
    2, height 1, dim 3, rot 2, vel 2, heatmap num_classes."""

    def __init__(self, ch: int, num_classes: int, head_conv: int = 64):
        super().__init__()
        self.names = [n for n, _ in PRED_HEADS] + ["heatmap"]
        for name, cout in PRED_HEADS + (("heatmap", num_classes),):
            self.add_module(name, nn.Sequential(_ConvModule1d(ch, head_conv), nn.Conv1d(head_conv, cout, 1)))
        nn.init.constant_(self.heatmap[1].bias, -2.19)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:  # [B, P, C]
        xt = x.transpose(1, 2)
        return {n: getattr(self, n)(xt).transpose(1, 2) for n in self.names}


class TransFusionHead(nn.Module):
    """TransFusion detection head, inference (heads/bbox/transfusion.py:
    37-345 + get_bboxes:715-800): BEV [B, in, H, W] -> dense heatmap ->
    3x3 local-max suppression (identity for the pedestrian and traffic-cone
    classes 8 and 9) -> top-K proposals over (class, cell) -> class-encoded
    queries -> transformer decoder (self + BEV cross attention) -> the FFN
    heads. `dense_heatmap` is NCHW."""

    def __init__(self, in_channels: int = 512, num_classes: int = 10, num_proposals: int = 200,
                 hidden: int = 128, num_decoder_layers: int = 1, heads: int = 8, ffn: int = 256,
                 nms_kernel: int = 3, out_size_factor: int = 8,
                 voxel_size: Tuple[float, float] = (0.075, 0.075),
                 pc_range: Tuple[float, float] = (-54.0, -54.0),
                 identity_nms_classes: Tuple[int, ...] = (8, 9)):
        super().__init__()
        self.num_classes, self.num_proposals, self.hidden = num_classes, num_proposals, hidden
        self.nms_kernel, self.out_size_factor = nms_kernel, out_size_factor
        self.voxel_size, self.pc_range = tuple(voxel_size), tuple(pc_range)
        self.identity_nms_classes = tuple(identity_nms_classes)
        self.shared_conv = nn.Conv2d(in_channels, hidden, 3, padding=1)
        self.heatmap_head = nn.Sequential(_ConvModule2d(hidden, hidden), nn.Conv2d(hidden, num_classes, 3, padding=1))
        nn.init.constant_(self.heatmap_head[1].bias, -2.19)
        self.class_encoding = nn.Conv1d(num_classes, hidden, 1)
        self.decoder = nn.ModuleList(TransformerDecoderLayer(hidden, heads, ffn) for _ in range(num_decoder_layers))
        self.prediction_heads = nn.ModuleList(PredictionFFN(hidden, num_classes) for _ in range(num_decoder_layers))

    def forward(self, bev: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, _, H, W = bev.shape
        hw = H * W
        feat = self.shared_conv(bev)
        dense_heatmap = self.heatmap_head(feat)                     # [B, C, H, W]
        peaks, top_class, top_index = self.proposals(dense_heatmap)
        feat_flat = feat.reshape(B, self.hidden, hw).transpose(1, 2)  # [B, HW, hidden]
        query_feat = torch.gather(feat_flat, 1, top_index[..., None].expand(-1, -1, self.hidden))
        one_hot = F.one_hot(top_class, self.num_classes).to(feat.dtype)
        query_feat = query_feat + self.class_encoding(one_hot.transpose(1, 2)).transpose(1, 2)

        ys, xs = torch.meshgrid(torch.arange(H, dtype=feat.dtype, device=feat.device),
                                torch.arange(W, dtype=feat.dtype, device=feat.device), indexing="ij")
        bev_pos = (torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1) + 0.5)[None].expand(B, hw, 2)
        query_pos = torch.gather(bev_pos, 1, top_index[..., None].expand(-1, -1, 2))
        heat_flat = peaks.reshape(B, self.num_classes, hw)
        query_heat_score = torch.gather(
            heat_flat, 2, top_index[:, None, :].expand(-1, self.num_classes, -1)).transpose(1, 2)

        preds: Dict[str, torch.Tensor] = {}
        for layer, head in zip(self.decoder, self.prediction_heads):
            query_feat = layer(query_feat, feat_flat, query_pos, bev_pos)
            preds = head(query_feat)
            preds["center"] = preds["center"] + query_pos
            query_pos = preds["center"].detach()
        preds["query_heatmap_score"] = query_heat_score
        preds["query_labels"] = top_class
        preds["dense_heatmap"] = dense_heatmap
        return preds

    def proposals(self, dense_heatmap: torch.Tensor):
        """dense_heatmap [B, C, H, W] -> (peaks [B, C, H, W], top_class
        [B, P], top_index [B, P]): the sigmoid heatmap's 3x3 local maxima
        (every cell of the identity classes) and the top P over (class,
        cell), in descending order, ties by index."""
        B, _, H, W = dense_heatmap.shape
        heatmap = dense_heatmap.sigmoid()
        k = self.nms_kernel
        pad = k // 2
        local_max = torch.zeros_like(heatmap)
        local_max[:, :, pad:H - pad, pad:W - pad] = F.max_pool2d(heatmap, k, stride=1, padding=0)
        for c in self.identity_nms_classes:
            local_max[:, c] = heatmap[:, c]
        peaks = heatmap * (heatmap == local_max)
        # a stable sort: equal scores in index order on every device, as
        # jax.lax.top_k orders them (torch.topk leaves ties unordered, and
        # the flat background of a BEV map ties)
        top = torch.sort(peaks.reshape(B, -1), dim=-1, descending=True, stable=True).indices[:, :self.num_proposals]
        return peaks, top // (H * W), top % (H * W)

    def decode_boxes(self, preds: Dict[str, torch.Tensor],
                     post_center_range=(-61.2, -61.2, -10.0, 61.2, 61.2, 10.0),
                     score_threshold: float = 0.0) -> Dict[str, torch.Tensor]:
        """TransFusionBBoxCoder.decode + get_bboxes' score fusion
        (coders/transfusion_bbox_coder.py:39-100, transfusion.py:723-732):
        per-proposal boxes [B, P, 9] with a `keep` mask."""
        one_hot = F.one_hot(preds["query_labels"], self.num_classes).to(preds["heatmap"].dtype)
        score = preds["heatmap"].sigmoid() * preds["query_heatmap_score"] * one_hot
        scores, labels = score.max(dim=-1)
        center, f = preds["center"], self.out_size_factor
        cx = center[..., 0] * f * self.voxel_size[0] + self.pc_range[0]
        cy = center[..., 1] * f * self.voxel_size[1] + self.pc_range[1]
        dim = preds["dim"].exp()
        z = preds["height"][..., 0] - dim[..., 2] * 0.5  # gravity centre -> bottom
        yaw = torch.atan2(preds["rot"][..., 0], preds["rot"][..., 1])
        boxes = torch.cat([torch.stack([cx, cy, z], -1), dim, yaw[..., None], preds["vel"]], dim=-1)
        lo = torch.tensor(post_center_range[:3], dtype=boxes.dtype, device=boxes.device)
        hi = torch.tensor(post_center_range[3:], dtype=boxes.dtype, device=boxes.device)
        keep = (scores > score_threshold) & (boxes[..., :3] >= lo).all(-1) & (boxes[..., :3] <= hi).all(-1)
        return {"bboxes": boxes, "scores": scores, "labels": labels, "keep": keep}


# ------------------------------------------------------------ composition
class BEVFusionDetector(nn.Module):
    """The camera + lidar detector (fusion_models/bevfusion.py:25-310,
    inference). `use_camera=False` is the lidar-only voxelnet; `fuser`
    says whether a ConvFuser sits between the encoders and the decoder
    (`has_fuser(state_dict)` reads it off a checkpoint). Built on `device`
    (CUDA unless the caller names another) in eval mode."""

    def __init__(self, use_camera: bool = True, num_classes: int = 10, num_proposals: int = 200,
                 camera_out: int = 80, fuse_channels: int = 256, lss_kwargs: Optional[Dict] = None,
                 head_kwargs: Optional[Dict] = None, fuser: bool = True, in_channels: int = 5,
                 device=None):
        from mobi_tpu_torch.models.diffusion import resolve_device
        from mobi_tpu_torch.models.swin import GeneralizedLSSFPN, SwinTransformer

        super().__init__()
        self.use_camera = use_camera
        self.encoders = nn.ModuleDict()
        if use_camera:
            self.encoders["camera"] = nn.ModuleDict({
                "backbone": SwinTransformer(),
                "neck": GeneralizedLSSFPN(out_channels=256),
                "vtransform": DepthLSSTransform(in_channels=256, out_channels=camera_out, **(lss_kwargs or {})),
            })
        encoder = SparseEncoder(in_channels)
        self.encoders["lidar"] = nn.ModuleDict({"backbone": encoder})
        lidar_channels = encoder.output_channels * 2  # the z ladder ends at depth 2 (see _grid)
        if fuser:
            self.fuser = ConvFuser((camera_out if use_camera else 0) + lidar_channels, fuse_channels)
        elif use_camera:
            raise ValueError("a camera + lidar detector needs a fuser")
        self.decoder = nn.ModuleDict({
            "backbone": SECONDBackbone(in_channels=fuse_channels if fuser else lidar_channels),
            "neck": SECONDFPN(),
        })
        self.heads = nn.ModuleDict({"object": TransFusionHead(
            num_classes=num_classes, num_proposals=num_proposals, **(head_kwargs or {}))})
        self.device = resolve_device(device)
        self.to(self.device)
        self.eval()

    def forward(self, voxel_feats: torch.Tensor, plans: Dict[str, Rulebook], out_coords: np.ndarray,
                out_shape: Tuple[int, int, int], images: Optional[torch.Tensor] = None,
                depth_map: Optional[torch.Tensor] = None,
                cells: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The lidar inputs of `prepare_lidar_inputs`; with the camera, the
        views [N, 3, H, W], their sparse depth maps and the LSS frustum's
        cells (`DepthLSSTransform.cells`)."""
        lidar_bev = self.encoders["lidar"]["backbone"](voxel_feats, plans, out_coords, out_shape)
        if self.use_camera:
            cam = self.encoders["camera"]
            feats = cam["neck"](cam["backbone"](images))
            cam_bev = cam["vtransform"](feats[0], depth_map, cells)
            # the LSS grid and the sparse encoder's BEV share the detector's
            # grid; a mismatch from padding arithmetic is resized bilinearly
            # with antialiasing on downsampling, as jax.image.resize does
            if cam_bev.shape[-2:] != lidar_bev.shape[-2:]:
                cam_bev = resize_bev(cam_bev, lidar_bev.shape[-2:])
            x = self.fuser([cam_bev, lidar_bev])
        else:
            x = self.fuser(lidar_bev) if hasattr(self, "fuser") else lidar_bev
        return self.heads["object"](self.decoder["neck"](self.decoder["backbone"](x)))

    def decode(self, preds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.heads["object"].decode_boxes(preds)


def resize_bev(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Half-pixel bilinear resize, antialiased when it shrinks (the
    `jax.image.resize(..., "bilinear")` of the JAX detector)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False, antialias=True)


def has_fuser(state_dict) -> bool:
    return "fuser.0.weight" in state_dict


def _grid(voxel_size, pc_range) -> Tuple[int, int, int]:
    nx, ny, nz = (int(round((pc_range[i + 3] - pc_range[i]) / voxel_size[i])) for i in range(3))
    # the reference's sparse_shape pads z by one over the voxel grid
    # ([1440, 1440, 41] for a z grid of 40), so the encoder's z ladder ends
    # at depth 2 and the dense lidar BEV has 2 * 128 channels
    return nx, ny, nz + 1


def prepare_lidar_inputs(points: np.ndarray, voxel_size=(0.075, 0.075, 0.2),
                         pc_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0), max_points: int = 10,
                         max_voxels: int = 120000, device=None):
    """Host stage: hard voxelize (native) + the sparse-conv plans; the mean
    VFE runs on `device` (CUDA unless named), where the plans' index pairs
    are copied too. Returns (feats [V, F], plans, out_coords, out_shape)."""
    from mobi_tpu_torch.models.diffusion import resolve_device

    dev = resolve_device(device)
    voxels, coords, npv = native.hard_voxelize(points, voxel_size, pc_range, max_points=max_points,
                                               max_voxels=max_voxels)
    feats = hard_simple_vfe(torch.from_numpy(voxels).to(dev), torch.from_numpy(npv).to(dev))
    plans, out_coords, out_shape = plan_sparse_encoder(coords, _grid(voxel_size, pc_range))
    for rb in plans.values():
        rb.pairs(dev)
    return feats, plans, out_coords, out_shape


def calibrate_static_caps(point_clouds, voxel_size=(0.075, 0.075, 0.2),
                          pc_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0), max_points: int = 10,
                          max_voxels: int = 120000, margin: float = 1.25,
                          multiple: int = 1024) -> Tuple[int, ...]:
    """Per-level caps from sample clouds, for padding the encoder's plan with
    `ops.sparse_conv.pad_rulebook` to fixed shapes: the plan's site counts
    (input voxels, after each stride-2 transition, after conv_out), times
    `margin`, rounded up to `multiple`; level 0 at most max_voxels. Plan
    `subm{i}` maps level i to i, `down{i}` i to i + 1, `out` the last stage
    to the last level."""
    grid = _grid(voxel_size, pc_range)
    maxima = [0] * (len(ENCODER_STAGES) + 1)
    for pts in point_clouds:
        _, coords, _ = native.hard_voxelize(np.asarray(pts), voxel_size, pc_range, max_points=max_points,
                                            max_voxels=max_voxels)
        plans, out_coords, _ = plan_sparse_encoder(coords, grid)
        maxima[0] = max(maxima[0], len(coords))
        for i in range(len(ENCODER_STAGES) - 1):
            maxima[i + 1] = max(maxima[i + 1], plans[f"down{i}"].n_out)
        maxima[-1] = max(maxima[-1], len(out_coords))

    def up(v):
        return max(int(np.ceil(v * margin / multiple)) * multiple, multiple)

    caps = [up(v) for v in maxima]
    caps[0] = min(caps[0], max_voxels)
    return tuple(caps)

