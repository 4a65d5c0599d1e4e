"""The paper's own simulated GPU configuration (Table II) as a config
module, so benchmarks and tests share one source of truth."""
from repro_torch.core.geometry import PAPER_GEOMETRY

CONFIG = PAPER_GEOMETRY
