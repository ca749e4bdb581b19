"""Dataset preparation CLIs of the port (the JAX package's data_tools/):

  python -m real_time_video_deepfake_detection_tpu_torch.data_tools.dfdc_process --zip ...
  python -m real_time_video_deepfake_detection_tpu_torch.data_tools.face_extract --videos ...

The JAX package's dfdc_download.py needs the network and is not ported.
"""
