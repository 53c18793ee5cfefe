"""Cross-silo message protocol constants: a copy of
`fedml_tpu/cross_silo/message_define.py` (reference:
cross_silo/server/message_define.py + client/message_define.py — the numeric
MSG_TYPE_* FSM alphabet; strings here for self-describing wire frames). The
SecAgg alphabet is kept so frames name the same types in both packages;
the SecAgg managers are not ported (ROADMAP 'Port queue' item 5)."""

# connection info (reference: MSG_TYPE_CONNECTION_IS_READY = 0)
CONNECTION_IS_READY = "connection_ready"

# server -> client (reference: 1, 2, 6, 7)
S2C_INIT_CONFIG = "s2c_init_config"
S2C_SYNC_MODEL = "s2c_sync_model"
S2C_CHECK_CLIENT_STATUS = "s2c_check_client_status"
S2C_FINISH = "s2c_finish"

# client -> server (reference: 3, 4, 5, 8)
C2S_SEND_MODEL = "c2s_send_model"
C2S_CLIENT_STATUS = "c2s_client_status"
C2S_FINISHED = "c2s_finished"
# liveness beacon (no reference analog: the reference server
# waits forever on dead clients). Lightweight, no payload beyond the
# generation echo; the server flips client_online off after a miss budget.
C2S_HEARTBEAT = "c2s_heartbeat"

# payload keys (reference: MSG_ARG_KEY_*)
KEY_MODEL_PARAMS = "model_params"
KEY_NUM_SAMPLES = "num_samples"
KEY_CLIENT_INDEX = "client_idx"
KEY_ROUND = "round_idx"
KEY_STATUS = "client_status"
KEY_METRICS = "metrics"
# run-generation (incarnation) fence: stamped on every S2C
# training message by the server and echoed on every C2S training message.
# A resumed server re-runs the round that was in flight when it died, so a
# pre-restart straggler's round-ECHO can equal the live round index — the
# transport's `_rel_epoch` fences *delivery*, not training semantics; this
# key fences the training FSM itself.
KEY_GENERATION = "run_gen"

STATUS_ONLINE = "ONLINE"
STATUS_FINISHED = "FINISHED"

# --- SecAgg extension (reference: cross_silo/secagg/sa_message_define.py —
# pk exchange 3/4, secret-share routing 5/6/11, active-client list 10)
C2S_SA_PK = "c2s_sa_pk"                    # MSG_TYPE_C2S_SEND_PK_TO_SERVER
S2C_SA_PKS = "s2c_sa_pks"                  # MSG_TYPE_S2C_OTHER_PK_TO_CLIENT
C2S_SA_SHARES = "c2s_sa_shares"            # MSG_TYPE_C2S_SEND_SS_TO_SERVER
S2C_SA_SHARES = "s2c_sa_shares"            # MSG_TYPE_S2C_OTHER_SS_TO_CLIENT
C2S_SA_MASKED = "c2s_sa_masked"            # masked model upload
S2C_SA_UNMASK_REQ = "s2c_sa_unmask_req"    # MSG_TYPE_S2C_ACTIVE_CLIENT_LIST
C2S_SA_UNMASK = "c2s_sa_unmask"            # MSG_TYPE_C2S_SEND_SS_OTHERS...

KEY_SA_PK = "sa_pk"
KEY_SA_PKS = "sa_pks"
KEY_SA_SHARES = "sa_shares"
KEY_SA_MASKED = "sa_masked"
KEY_SA_SURVIVORS = "sa_survivors"
KEY_SA_DROPPED = "sa_dropped"
KEY_SA_B_SHARES = "sa_b_shares"
KEY_SA_SK_SHARES = "sa_sk_shares"
KEY_SA_THRESHOLD = "sa_threshold"
KEY_SA_QBITS = "sa_q_bits"
# N = sum(n_i): broadcast with the pk list so clients mask normalized
# weights n_i/N (field budget stays count-scale-free)
KEY_SA_WEIGHT_NORM = "sa_weight_norm"
