"""The fused device scoring pipeline (`device_path`)."""
