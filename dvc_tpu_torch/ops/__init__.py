from .ms_deform_attn import ms_deform_attn, ms_deform_attn_ref
from .dsa_greedy import (dsa_greedy_scan, dsa_greedy_scan_ref,
                         greedy_mask_outputs)

__all__ = ['ms_deform_attn', 'ms_deform_attn_ref', 'dsa_greedy_scan',
           'dsa_greedy_scan_ref', 'greedy_mask_outputs']
