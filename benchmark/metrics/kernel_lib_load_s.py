"""Host seconds of loading the program's kernel library
(utils/cudalib.lib: from its cache inside the checkout, or its nvcc build
on a checkout's first run); none on the CPU, where no kernel runs."""


def read(run):
    return run.kernel_lib_load_s or None
