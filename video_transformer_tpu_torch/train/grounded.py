"""Grounded clips and teacher notes: clips whose notes describe their frames.

This package's own copy of the topic bank, the clip renderers and the
teacher-note builders of the JAX package's ``train/grounded.py`` (numpy
only). Each topic owns a deterministic visual signature (hue pair, stripe
orientation and frequency, moving-shape count) rendered into synthetic
lecture clips, and its teacher note names that topic's terms. The grounding
eval (``train/eval_grounding.py``) renders unseen clips with these and
scores a hit when the generated note names the clip's topic. The clips and
notes are byte-equal to the JAX package's for the same rng.

All note text stays inside the constrained-decoding alphabet (ASCII + CJK
ideographs), so every note replays through the note grammar.
"""

from __future__ import annotations

import colorsys
from dataclasses import dataclass

import numpy as np

__all__ = [
    "COUNT_NAMES",
    "ORIENT_NAMES",
    "TOPIC_BANK",
    "Topic",
    "render_topic_clip",
    "render_composite_clip",
    "render_band_clip",
    "grounded_note",
    "composite_note",
]


@dataclass(frozen=True)
class Topic:
    name: str  # Chinese topic term (appears in title/takeaways)
    gloss: str  # one-line definition
    terms: tuple[str, ...]  # related glossary terms
    action: str  # verb phrase for takeaways


TOPIC_BANK: tuple[Topic, ...] = (
    Topic("梯度下降", "沿负梯度方向迭代更新参数以最小化损失", ("学习率", "损失函数"), "更新模型参数"),
    Topic("反向传播", "按链式法则自输出层向输入层传递梯度", ("链式法则", "计算图"), "计算每层梯度"),
    Topic("注意力机制", "按查询与键的相似度加权聚合值向量", ("查询向量", "键值对"), "聚合上下文信息"),
    Topic("卷积神经网络", "用共享卷积核提取局部空间特征", ("卷积核", "感受野"), "提取图像特征"),
    Topic("循环神经网络", "沿时间步传递隐藏状态建模序列", ("隐藏状态", "时间步"), "建模序列依赖"),
    Topic("正则化", "对参数施加约束以抑制过拟合", ("权重衰减", "泛化能力"), "抑制过拟合"),
    Topic("批归一化", "按批次统计量规范化激活分布", ("均值方差", "训练稳定性"), "稳定训练过程"),
    Topic("词向量", "把离散词映射为稠密连续向量", ("嵌入矩阵", "语义相似度"), "表示词语语义"),
    Topic("微调", "在预训练权重上用下游数据继续训练", ("预训练", "下游任务"), "适配下游任务"),
    Topic("过拟合", "模型记住训练集噪声导致泛化变差", ("训练误差", "验证误差"), "降低泛化能力"),
    Topic("学习率调度", "训练中按计划调整步长", ("预热阶段", "余弦衰减"), "控制收敛速度"),
    Topic("残差连接", "跨层相加让梯度直达浅层", ("恒等映射", "梯度流"), "缓解梯度消失"),
    Topic("层归一化", "对单个样本的特征维度做规范化", ("特征维度", "尺度不变"), "规范激活分布"),
    Topic("自监督学习", "从无标注数据构造监督信号", ("掩码预测", "对比学习"), "利用无标注数据"),
    Topic("知识蒸馏", "让小模型拟合大模型的输出分布", ("教师模型", "学生模型"), "压缩模型规模"),
    Topic("数据增强", "对样本做保语义变换扩充数据", ("随机裁剪", "颜色抖动"), "扩充训练数据"),
    Topic("损失函数", "度量预测与目标差距的标量函数", ("交叉熵", "均方误差"), "度量预测误差"),
    Topic("优化器", "依据梯度与状态决定参数更新量", ("动量项", "自适应步长"), "决定更新方向"),
    Topic("模型量化", "用低位宽数值表示权重与激活", ("定点表示", "量化误差"), "降低推理成本"),
    Topic("束搜索", "每步保留若干最优部分序列", ("候选序列", "搜索宽度"), "搜索输出序列"),
    Topic("位置编码", "向序列注入位置信息", ("正弦编码", "旋转编码"), "编码位置信息"),
    Topic("混合精度", "用半精度计算配合全精度累加", ("半精度", "数值稳定"), "加速矩阵计算"),
    Topic("模型并行", "把参数切分到多个设备上", ("张量切分", "设备网格"), "扩展模型规模"),
    Topic("数据并行", "多设备各算一份梯度再求和", ("梯度同步", "批次切分"), "扩展训练吞吐"),
    # Appended after round 2 started: indices 0-23 above are FROZEN — the
    # shipped tiny checkpoint and the e2e tests reference them by position.
    Topic("激活函数", "给线性变换引入非线性映射", ("非线性", "饱和区间"), "引入非线性"),
    Topic("池化层", "对局部区域取统计量降低分辨率", ("最大池化", "平均池化"), "压缩空间维度"),
    Topic("随机失活", "训练时随机屏蔽部分神经元", ("屏蔽概率", "集成效应"), "抑制共适应"),
    Topic("交叉验证", "轮换划分训练集与验证集评估模型", ("数据划分", "评估方差"), "评估泛化性能"),
    Topic("特征工程", "从原始数据构造有判别力的输入", ("特征选择", "特征缩放"), "构造输入特征"),
    Topic("梯度裁剪", "限制梯度范数防止更新爆炸", ("梯度范数", "裁剪阈值"), "稳定更新幅度"),
    Topic("早停策略", "验证指标不再改善时停止训练", ("验证指标", "耐心轮数"), "防止过度训练"),
    Topic("集成学习", "组合多个弱模型提升整体精度", ("投票机制", "模型多样性"), "组合多个模型"),
    Topic("决策树", "按特征阈值递归划分样本空间", ("信息增益", "叶子节点"), "划分样本空间"),
    Topic("支持向量机", "寻找间隔最大的分类超平面", ("核函数", "支持向量"), "最大化分类间隔"),
    Topic("聚类分析", "按相似度把样本分成若干组", ("簇中心", "距离度量"), "划分样本组别"),
    Topic("降维方法", "把高维数据映射到低维空间", ("主成分", "方差保留"), "压缩数据维度"),
    Topic("强化学习", "智能体通过试错最大化累积奖励", ("奖励信号", "策略函数"), "学习决策策略"),
    Topic("生成对抗", "生成器与判别器相互博弈训练", ("生成器", "判别器"), "生成逼真样本"),
    Topic("扩散模型", "学习逐步去噪恢复数据分布", ("加噪过程", "去噪网络"), "生成高质样本"),
    Topic("对比学习", "拉近正样本对并推远负样本对", ("正样本对", "温度系数"), "学习判别表示"),
    Topic("迁移学习", "把源任务知识迁移到目标任务", ("源任务", "目标任务"), "复用已学知识"),
    Topic("多模态对齐", "把不同模态映射到共享语义空间", ("共享空间", "跨模态检索"), "对齐多种模态"),
    Topic("图神经网络", "沿边聚合邻居信息更新节点表示", ("邻居聚合", "消息传递"), "建模图结构"),
    Topic("序列到序列", "编码输入序列再解码输出序列", ("编码器", "解码器"), "转换序列形式"),
    Topic("缓存推理", "缓存键值对避免重复前向计算", ("键值缓存", "增量解码"), "加速自回归生成"),
    Topic("稀疏专家", "按路由选择少数专家参与计算", ("路由器", "专家容量"), "扩展参数规模"),
    Topic("检索增强", "检索外部知识拼接进生成上下文", ("向量检索", "知识库"), "补充外部知识"),
    Topic("思维链", "让模型先生成推理步骤再给答案", ("推理步骤", "中间结论"), "提升推理质量"),
)


# ---------------------------------------------------------------------------
# Visual signatures
# ---------------------------------------------------------------------------


def _topic_palette(idx: int) -> tuple[np.ndarray, np.ndarray]:
    """Two maximally-separated RGB colors for topic ``idx``."""
    hue = (idx * 0.618034) % 1.0  # golden-ratio hop: far-apart hues
    fg = np.array(colorsys.hsv_to_rgb(hue, 0.95, 1.0)) * 255
    bg = np.array(colorsys.hsv_to_rgb((hue + 0.5) % 1.0, 0.6, 0.35)) * 255
    return fg.astype(np.float32), bg.astype(np.float32)


#: Attribute vocabulary for frame-attribute grounding (names appear in
#: teacher notes and are checked by the JAX package's train/eval_content.py --attrs):
#: stripe orientation 0/1/2 and moving-shape count 1..5.
ORIENT_NAMES = ("横向", "纵向", "斜向")
COUNT_NAMES = ("一", "二", "三", "四", "五")


def render_topic_clip(
    topic_idx: int,
    num_frames: int,
    size: int,
    rng: np.random.Generator | None = None,
    orient: int | None = None,
    n_shapes: int | None = None,
) -> np.ndarray:
    """uint8 [T, size, size, 3] clip carrying topic ``topic_idx``'s signature.

    Signature channels (all discriminable at 64x64 by a 2-layer ViT):
    - color pair: golden-ratio hue for the topic index;
    - stripe field: orientation in {horizontal, vertical, diagonal} and
      frequency 2 + idx % 4, drifting over time (motion cue);
    - shape count: 1 + idx % 5 moving square highlights.
    Small additive noise keeps samples distinct without hiding the signal.

    ``orient``/``n_shapes`` override the idx-derived defaults for
    FRAME-ATTRIBUTE grounding: when an attribute is decoupled from the
    topic identity and the teacher note states it (grounded_note attrs),
    the model can only get it right by reading THIS clip's pixels — class
    identity no longer predicts it. Defaults (None) keep the historical
    idx-bound rendering byte-identical, so existing checkpoints/evals are
    untouched.
    """
    rng = rng or np.random.default_rng(topic_idx)
    idx = topic_idx % len(TOPIC_BANK)
    fg, bg = _topic_palette(idx)
    orient = idx % 3 if orient is None else int(orient) % 3
    freq = 2 + idx % 4
    n_shapes = 1 + idx % 5 if n_shapes is None else int(n_shapes)

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    field = {0: yy, 1: xx, 2: (xx + yy) / 2}[orient]

    frames = np.empty((num_frames, size, size, 3), np.float32)
    for t in range(num_frames):
        phase = t / max(num_frames, 1)
        wave = 0.5 + 0.5 * np.sin(2 * np.pi * (freq * field + phase))
        img = bg[None, None, :] + wave[:, :, None] * (fg - bg)[None, None, :]
        # moving square highlights
        for s in range(n_shapes):
            cx = int(((s + 1) / (n_shapes + 1) + 0.3 * phase) % 1.0 * size)
            cy = int((0.2 + 0.6 * s / max(n_shapes, 1)) * size)
            half = max(size // 12, 2)
            img[
                max(cy - half, 0) : cy + half, max(cx - half, 0) : cx + half
            ] = fg[None, None, :]
        img += rng.normal(0.0, 6.0, img.shape)
        frames[t] = img
    return np.clip(frames, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Teacher notes
# ---------------------------------------------------------------------------


def _ts(seconds: int) -> str:
    return f"{seconds // 60:02d}:{seconds % 60:02d}"


def _section(
    topic_name: str,
    focus: str,
    other: str,
    start: int,
    rng: np.random.Generator,
) -> dict:
    explain = (
        f"{focus}是{topic_name}的关键环节",
        f"{focus}决定{topic_name}的最终效果",
        f"掌握{focus}才能正确使用{topic_name}",
    )
    codes = ("y = step(x)", "v = update(v)", "h = layer(h)", "p = fit(p)")
    return {
        "topic": focus,
        "timestamp": _ts(start),
        "explanation": explain[int(rng.integers(len(explain)))],
        "example": f"例如结合{other}演示{focus}的用法",
        "code": codes[int(rng.integers(len(codes)))],
        "common_mistakes": [f"忽略{other}的影响", f"混淆{focus}与{other}"][
            : int(rng.integers(1, 3))
        ],
        "connections": [other],
        "self_check": [
            {"q": f"{focus}的作用", "a": f"{focus}支撑{topic_name}"}
        ],
    }


def grounded_note(
    topic: Topic,
    rng: np.random.Generator,
    attrs: tuple[int, int] | None = None,
) -> dict:
    """A schema-valid note whose content names ``topic`` and its terms.

    Field lengths fit the note grammar at scale 1.0; phrasing varies so the
    model learns content-conditioning, not a fixed string. Two or three
    chapters (principle / practice / pitfalls) with 2 sections each give the
    rendered note enough material that segment merges reach the 400
    lines-per-hour budget floor (the JAX package's utils/refiner_contract.py).

    ``attrs`` = (orient, n_shapes) as rendered by render_topic_clip's
    overrides: the note then STATES the clip's visual attributes (a
    takeaway + a 画面特征 glossary entry) — frame-determined content that
    topic identity cannot predict, so eval can verify the model actually
    read this clip (the JAX package's train/eval_content.py --attrs).
    """
    t1, t2 = topic.terms
    openers = ("本讲解析", "重点讲解", "系统梳理", "深入剖析")
    start = int(rng.integers(0, 30))

    def chapter(title: str, summary: str, focuses, base: int) -> dict:
        return {
            "chapter_title": title,
            "chapter_summary": summary,
            "chapter_self_check": [
                {"q": f"什么是{topic.name}", "a": topic.gloss[:18]}
            ],
            "sections": [
                _section(topic.name, focus, other, base + 20 * j, rng)
                for j, (focus, other) in enumerate(focuses)
            ],
        }

    chapters = [
        chapter(
            f"{topic.name}原理",
            f"{openers[0]}{topic.name}的核心机制",
            [(topic.name, t1), (t1, t2)],
            start,
        ),
        chapter(
            f"{topic.name}实践",
            f"结合实例演示{topic.name}的应用",
            [(t2, topic.name), (t1, topic.name)],
            start + 60,
        ),
    ]
    if rng.random() < 0.5:
        chapters.append(
            chapter(
                f"{topic.name}常见误区",
                f"剖析使用{topic.name}时的典型错误",
                [(topic.name, t2)],
                start + 120,
            )
        )
    takeaways = [
        f"{topic.name}{topic.action}",
        f"{t1}是理解{topic.name}的基础",
        f"{t2}配合{topic.name}使用效果更好",
    ][: int(rng.integers(2, 4))]
    glossary = {topic.name[:8]: topic.gloss, t1[:8]: f"{t1}支撑{topic.name}"}
    if attrs is not None:
        orient, n_shapes = attrs
        o_name = ORIENT_NAMES[int(orient) % 3]
        c_name = COUNT_NAMES[int(n_shapes) - 1]
        takeaways.append(f"画面以{o_name}条纹展示{c_name}个移动方块")
        glossary["画面特征"] = f"{o_name}条纹配{c_name}个方块高亮"
    return {
        "title": f"{topic.name}{openers[int(rng.integers(len(openers)))]}",
        "one_sentence_summary": f"{topic.name}{topic.action}",
        "key_takeaways": takeaways,
        "deep_dive": chapters,
        "glossary": glossary,
        "visual_schemas": [
            {
                "type": "overview",
                "description": f"{topic.name}总览",
                "schema": f"{t1} -> {topic.name} -> {t2}",
            }
        ],
    }


def render_composite_clip(
    primary_idx: int,
    secondary_idx: int,
    num_frames: int,
    size: int,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """A clip carrying TWO topic signatures: primary on the top band,
    secondary on the bottom band (60/40 split).

    Compositional grounding: the note must name the primary topic in its
    title AND surface the secondary in takeaways/connections, so the model
    has to read both regions — single-signature shortcuts (global color
    statistics) stop working.

    The bottom band holds the secondary's FULL frame vertically squeezed
    into the band (nearest-neighbor rows, stripes and shapes stay crisp) —
    not a crop of its bottom rows. Round-2 composites cropped, which
    discarded the shape-count channel entirely (the moving squares live at
    0.2-0.8 of frame height, mostly above the crop) and left the band
    carrying only hue + stripes; two-signature grounding sat at 0/8
    (ROADMAP round-2 diagnosis: the secondary's band signal "dies in
    pooling" — it was never fully there). Squeezing preserves all three
    signature channels at band scale.
    """
    rng = rng or np.random.default_rng(primary_idx * 97 + secondary_idx)
    top = render_topic_clip(primary_idx, num_frames, size, rng)
    bottom = render_topic_clip(secondary_idx, num_frames, size, rng)
    split = int(size * 0.6)
    band_rows = np.linspace(0, size - 1, size - split).round().astype(int)
    frames = top.copy()
    frames[:, split:] = bottom[:, band_rows]
    return frames


def render_band_clip(
    topic_idx: int,
    num_frames: int,
    size: int,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """A clip whose signature occupies ONLY the composite's bottom band;
    the top 60% is a neutral drifting gray gradient.

    Curriculum decomposition for compositional grounding: pairing these
    with the topic's ordinary single-topic note gives DIRECT supervision
    for "read the band region -> name its topic", decoupled from the
    composite note format — composites then combine two separately
    learned skills instead of demanding both at once.
    """
    rng = rng or np.random.default_rng(topic_idx * 131)
    sig = render_topic_clip(topic_idx, num_frames, size, rng)
    split = int(size * 0.6)
    band_rows = np.linspace(0, size - 1, size - split).round().astype(int)
    yy = np.mgrid[0:size, 0:size][0].astype(np.float32) / size
    frames = np.empty_like(sig)
    for t in range(num_frames):
        phase = t / max(num_frames, 1)
        gray = 90 + 60 * ((yy + phase) % 1.0)
        neutral = np.repeat(gray[:, :, None], 3, axis=2)
        neutral += rng.normal(0.0, 6.0, neutral.shape)
        frames[t] = np.clip(neutral, 0, 255).astype(np.uint8)
    frames[:, split:] = sig[:, band_rows]
    return frames


def composite_note(
    primary: Topic, secondary: Topic, rng: np.random.Generator
) -> dict:
    """A note naming the primary topic up front and weaving the secondary
    through takeaways / a dedicated chapter / glossary."""
    note = grounded_note(primary, rng)
    t1 = secondary.terms[0]
    note["key_takeaways"] = note["key_takeaways"][:2] + [
        f"{secondary.name}{secondary.action}"
    ]
    note["deep_dive"].append(
        {
            "chapter_title": f"{secondary.name}延伸",
            "chapter_summary": f"结合{primary.name}讲解{secondary.name}",
            "chapter_self_check": [
                {"q": f"什么是{secondary.name}", "a": secondary.gloss[:18]}
            ],
            "sections": [
                _section(
                    secondary.name, secondary.name, primary.name,
                    200 + int(rng.integers(0, 30)), rng,
                )
            ],
        }
    )
    note["glossary"][secondary.name[:8]] = secondary.gloss
    note["glossary"][t1[:8]] = f"{t1}支撑{secondary.name}"
    return note
