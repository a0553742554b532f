"""EMVB's own production retrieval config at MS MARCO scale (paper §5;
counterpart of ``repro/configs/emvb_msmarco.py``): 8.8M passages, ~600M
token embeddings (d = 128), |C| = 2^18 centroids, PQ m = 16 x 8 bits,
n_q = 32, as the ``--arch emvb-msmarco`` entry. ``chip_smoke.py`` serves
these widths on the card."""
import dataclasses

from ..core.engine import EngineConfig
from .registry import ArchSpec, ShapeCell, register


@dataclasses.dataclass(frozen=True)
class EMVBProdConfig:
    name: str = "emvb-msmarco"
    n_docs: int = 8_841_823          # MS MARCO passage count
    doc_cap: int = 80                # padded tokens/passage (avg ~67)
    d: int = 128
    n_centroids: int = 1 << 18
    m: int = 16
    nbits: int = 8
    list_cap: int = 4096
    engine: EngineConfig = EngineConfig(
        n_q=32, nprobe=4, th=0.4, th_r=0.5, n_filter=1024, n_docs=256,
        k=100)


def make_config() -> EMVBProdConfig:
    return EMVBProdConfig()


def make_smoke_config() -> EMVBProdConfig:
    return EMVBProdConfig(
        name="emvb-smoke", n_docs=512, doc_cap=24, n_centroids=128, m=8,
        nbits=4, list_cap=64,
        engine=EngineConfig(n_q=32, nprobe=4, th=0.3, th_r=0.4, n_filter=64,
                            n_docs=16, k=10))


SHAPES = {
    "serve_b32": ShapeCell("retrieve", {"query_batch": 32}),
    "serve_b1": ShapeCell("retrieve", {"query_batch": 1}),
}

SPEC = register(ArchSpec(
    name="emvb-msmarco", family="retrieval", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=SHAPES, optimizer="adamw",
    model_flops_params={"n_params": 0, "moe": False},
    notes="the paper's own system; latency benchmarks in benchmarks/"))
