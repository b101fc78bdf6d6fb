from repro_torch.core.groups import LayerGroup, enumerate_groups, stable_group_id
from repro_torch.core.signatures import LayerRecord, records_from_params
from repro_torch.core.store import ParamStore

__all__ = ["LayerGroup", "LayerRecord", "ParamStore", "enumerate_groups",
           "records_from_params", "stable_group_id"]
