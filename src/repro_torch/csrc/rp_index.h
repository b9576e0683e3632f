// Packed-ABI constants shared by the bank-FSM kernels (K1, K2, K3).
//
// Mirrors repro_torch/core/params.py: RP_* is the column of each runtime
// parameter in the packed [T*S, NP] rows (RuntimeParams field order), S_* the
// bank FSM states, CMD_* the command-bus codes, P_* the open-page
// after-precharge codes, SCHED_FRFCFS the row-hit-first policy flag. tests/test_torch_params.py parses this header and
// holds every value against the Python package.
#pragma once

#define RP_tRP 0
#define RP_tFAW 1
#define RP_tRRDL 2
#define RP_tRCDRD 3
#define RP_tRCDWR 4
#define RP_tCCDL 5
#define RP_tWTR 6
#define RP_tRFC 7
#define RP_tREFI 8
#define RP_tCL 9
#define RP_tXS 10
#define RP_tRTW 11
#define RP_sref_idle_cycles 12
#define RP_page_policy 13
#define RP_sched_policy 14
#define RP_tier_interleave_log2 15
#define RP_tier_cxl_frac_log2 16
#define NUM_RUNTIME_PARAMS 17

#define PAGE_OPEN 1
#define SCHED_FRFCFS 1

#define S_IDLE 0
#define S_REF_ISSUE 1
#define S_REF_WAIT 2
#define S_SREF_ISSUE 3
#define S_SREF 4
#define S_SREF_EXIT_ISSUE 5
#define S_SREF_EXIT_WAIT 6
#define S_ACT_ISSUE 7
#define S_ACT_WAIT 8
#define S_RW_ISSUE 9
#define S_RW_WAIT 10
#define S_PRE_ISSUE 11
#define S_PRE_WAIT 12
#define S_RESP_PEND 13

#define CMD_NOP 0
#define CMD_ACT 1
#define CMD_RD 2
#define CMD_WR 3
#define CMD_PRE 4
#define CMD_REF 5
#define CMD_SREF_ENTER 6
#define CMD_SREF_EXIT 7

#define P_NONE 0
#define P_RW 1
#define P_REF 2
#define P_SREF 3

#define EVENT_INF 0x3FFFFFFF
#define SCHEDULE_INF 0x3FFFFFFF
// dram_model's "legal since long ago" command time
#define NEG_TIME (-(1 << 20))
