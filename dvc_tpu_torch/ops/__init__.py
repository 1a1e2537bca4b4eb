from .assignment import (assignment, assignment_ref,
                         linear_sum_assignment_ref, many_to_one_assignment,
                         masked_assignment)
from .ms_deform_attn import (ms_deform_attn, ms_deform_attn_bwd,
                             ms_deform_attn_ref, ms_deform_attn_sample_values)
from .dsa_greedy import (dsa_greedy_scan, dsa_greedy_scan_ref,
                         greedy_mask_outputs, greedy_pick, lstm_cell,
                         step_pos_hvec)
from .dsa_scan import (dsa_teacher_scan, dsa_teacher_scan_bwd,
                       dsa_teacher_scan_fwd, dsa_teacher_scan_ref)
from .dsa_tables import table_gemm, table_gemm_ref
from .dsa_step import (dsa_lstm_step_bwd, dsa_lstm_step_core,
                       dsa_lstm_step_fwd, dsa_sample_attend_bwd,
                       dsa_sample_attend_core, dsa_sample_attend_fwd,
                       dsa_sample_attend_table_core, lstm_step_ref,
                       pack_attend_weights, sample_attend_ref,
                       sample_attend_table_ref)

__all__ = ['assignment', 'assignment_ref', 'linear_sum_assignment_ref',
           'many_to_one_assignment', 'masked_assignment',
           'ms_deform_attn', 'ms_deform_attn_bwd', 'ms_deform_attn_ref',
           'ms_deform_attn_sample_values',
           'dsa_greedy_scan', 'dsa_greedy_scan_ref', 'greedy_mask_outputs',
           'greedy_pick', 'lstm_cell', 'step_pos_hvec',
           'dsa_teacher_scan', 'dsa_teacher_scan_bwd', 'dsa_teacher_scan_fwd',
           'dsa_teacher_scan_ref',
           'dsa_lstm_step_bwd', 'dsa_lstm_step_core', 'dsa_lstm_step_fwd',
           'dsa_sample_attend_bwd', 'dsa_sample_attend_core',
           'dsa_sample_attend_fwd', 'dsa_sample_attend_table_core',
           'lstm_step_ref', 'pack_attend_weights', 'sample_attend_ref',
           'sample_attend_table_ref',
           'table_gemm', 'table_gemm_ref']
