"""Host-side native code of the port, built with the host C/C++ compiler at first use."""
