from .ms_deform_attn import (ms_deform_attn, ms_deform_attn_bwd,
                             ms_deform_attn_ref)
from .dsa_greedy import (dsa_greedy_scan, dsa_greedy_scan_ref,
                         greedy_mask_outputs)
from .dsa_scan import (dsa_teacher_scan, dsa_teacher_scan_bwd,
                       dsa_teacher_scan_fwd, dsa_teacher_scan_ref)

__all__ = ['ms_deform_attn', 'ms_deform_attn_bwd', 'ms_deform_attn_ref',
           'dsa_greedy_scan', 'dsa_greedy_scan_ref', 'greedy_mask_outputs',
           'dsa_teacher_scan', 'dsa_teacher_scan_bwd', 'dsa_teacher_scan_fwd',
           'dsa_teacher_scan_ref']
