"""The cells at a size a CPU test run holds: width 8, the program in
float32, a few small frames or rows."""

TINY = {
    "sharp_vot_1obj": {"config": {"width": 8, "dtype": "float32"},
                       "traffic": {"pool_frames": 4, "video_frames": 8, "reinit_at": [4],
                                   "check_frames": 8, "warmup_frames": 1,
                                   "frame_sizes": [[96, 160], [120, 200]],
                                   "target_side": [20, 40], "amplitude": 6}},
    "sharp_vos_16obj": {"config": {"width": 8, "dtype": "float32"},
                        "traffic": {"objects": 3, "chunk": 2, "pool_frames": 4,
                                    "check_frames": 4, "frame_size": [120, 200],
                                    "centre": [40, 80], "size": [20, 40], "amplitude": 5}},
    "base_train_b64": {"config": {"width": 8, "dtype": "float32"},
                       "traffic": {"batch": 4, "pool_batches": 4, "warmup_steps": 0}},
    # four gloo ranks on the CPU, two rows each
    "base_train_dp4": {"config": {"width": 8, "dtype": "float32"},
                       "traffic": {"batch": 8, "pool_batches": 4, "warmup_steps": 0}},
}
