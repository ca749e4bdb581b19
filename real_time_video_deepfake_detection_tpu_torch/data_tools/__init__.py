"""Dataset preparation CLIs of the port (the JAX package's data_tools/):

  python -m real_time_video_deepfake_detection_tpu_torch.data_tools.dfdc_process --zip ...
  python -m real_time_video_deepfake_detection_tpu_torch.data_tools.face_extract --videos ...
  python -m real_time_video_deepfake_detection_tpu_torch.data_tools.dfdc_download --parts 10

dfdc_download needs the network (and Kaggle credentials) when it runs.
"""
