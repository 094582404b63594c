"""Hand-written CUDA kernels with their plain PyTorch versions: K1 fused
step (`fused_step`), K2 GBDT (`gbdt`), K5 persistent multi-step
(`persistent_step`), K6 masked distance and its row-id variant
(`distance.sqdist_masked`, `distance.sqdist_rows`), K6q compressed
distance by row id (`quant_rows.sqdist_rows_quant`), K7 sorted-buffer
merge (`topk.topm_merge`); `ops` dispatches by the reference's names."""
from repro_torch.kernels.distance import (sqdist_masked, sqdist_masked_plain,
                                          sqdist_rows, sqdist_rows_plain)
from repro_torch.kernels.fused_step import fused_step, fused_step_plain
from repro_torch.kernels.gbdt import gbdt_predict, gbdt_predict_plain
from repro_torch.kernels.persistent_step import (persistent_multi_step,
                                                 persistent_multi_step_plain)
from repro_torch.kernels.quant_rows import (sqdist_rows_quant,
                                            sqdist_rows_quant_plain)
from repro_torch.kernels.topk import topm_merge, topm_merge_plain

__all__ = ["sqdist_masked", "sqdist_masked_plain", "sqdist_rows",
           "sqdist_rows_plain", "fused_step", "fused_step_plain",
           "gbdt_predict", "gbdt_predict_plain", "persistent_multi_step",
           "persistent_multi_step_plain", "sqdist_rows_quant",
           "sqdist_rows_quant_plain", "topm_merge", "topm_merge_plain"]
